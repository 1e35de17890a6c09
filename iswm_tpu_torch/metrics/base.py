"""Metrics ABC (reference metrics/base.py:3-42)."""

from abc import ABC, abstractmethod


class MetricsBase(ABC):
    @abstractmethod
    def update(self, *args, **kwargs):
        ...

    @abstractmethod
    def get_results(self):
        ...

    @abstractmethod
    def reset(self):
        ...

    def to_str(self, results) -> str:
        return "\n".join(f"{k}: {v}" for k, v in dict(results).items())

"""Binary confusion matrix of labels and predictions: the CUDA kernel
``csrc/confusion.cu`` for Hopper, its wrapper and its plain version.

Counterpart of ``iswm_tpu/ops/pallas/confusion.py``
``binary_confusion_matrix``.  For integer labels and predictions of any
(equal) shape:

    out[2, 2] f32 = [[tn, fp], [fn, tp]]      (rows = true class)

A pixel counts when its label is 0 or 1; 255 and every other label are
excluded.  A prediction counts as class 1 only when it equals 1.  The
kernel counts in 64-bit integers, so the matrix is exact for any number of
pixels wherever its entries are representable in float32 (the TPU kernel's
float32 running sums are exact only up to 2**24 pixels per call).

The wrapper launches the kernel for a CUDA tensor and uses the plain
version only for a CPU tensor.  ``launches`` counts kernel launches (one
per call: the two-stage reduction is one launch of the wrapper).
"""

from __future__ import annotations

import ctypes

import torch

launches = 0
_lib = None
_KINDS = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}


def load_library() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the kernel; returns (library, nvcc log)."""
    global _lib
    log = ""
    if _lib is None:
        from .build import load_library as build_and_load

        lib, log = build_and_load("confusion")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.iswm_binary_confusion.argtypes = [
            ptr, i32, ptr, i32, ctypes.c_longlong, ptr, ptr, ptr,
        ]
        lib.iswm_binary_confusion.restype = i32
        lib.iswm_confusion_max_blocks.restype = i32
        lib.iswm_cuda_error_string.argtypes = [i32]
        lib.iswm_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib, log


def _check(gts: torch.Tensor, preds: torch.Tensor) -> None:
    if gts.numel() != preds.numel():
        raise ValueError(f"labels {tuple(gts.shape)} and predictions "
                         f"{tuple(preds.shape)} differ in size")
    for name, t in (("labels", gts), ("predictions", preds)):
        if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
            raise TypeError(f"{name} must be integers, got {t.dtype}")


def binary_confusion_matrix_plain(gts: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the masked arithmetic of the TPU kernel's
    body, summed in float64 (exact below 2**53 pixels)."""
    _check(gts, preds)
    gt = gts.reshape(-1)
    pred = preds.reshape(-1)
    valid = (gt >= 0) & (gt < 2)
    g = (valid & (gt == 1)).double()
    p = (pred == 1).double()
    v = valid.double()
    tp = torch.sum(g * p)
    fn = torch.sum(g * (1.0 - p) * v)
    fp = torch.sum((1.0 - g) * p * v)
    tn = torch.sum((1.0 - g) * (1.0 - p) * v)
    return torch.stack([tn, fp, fn, tp]).float().reshape(2, 2)


def binary_confusion_matrix(gts: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """[...] int labels/preds -> [2, 2] f32 confusion matrix (rows = true)
    on the labels' device (see the module docstring)."""
    _check(gts, preds)
    if gts.device.type == "cpu":
        return binary_confusion_matrix_plain(gts, preds)
    if gts.device.type != "cuda":
        raise ValueError(f"binary_confusion_matrix runs on CUDA or CPU, not {gts.device}")
    if preds.device != gts.device:
        raise ValueError("labels and predictions must be on one device")
    for name, t in (("labels", gts), ("predictions", preds)):
        if t.dtype not in _KINDS:
            raise TypeError(f"{name} must be uint8, int32 or int64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.cuda.get_device_capability(gts.device) != (9, 0):
        raise RuntimeError("the confusion kernel is built for sm_90a (H100/H200)")
    if gts.numel() == 0:
        return torch.zeros((2, 2), dtype=torch.float32, device=gts.device)
    lib, _ = load_library()
    partials = torch.empty(4 * lib.iswm_confusion_max_blocks(), dtype=torch.int64,
                           device=gts.device)
    out = torch.empty((2, 2), dtype=torch.float32, device=gts.device)
    global launches
    with torch.cuda.device(gts.device):
        stream = torch.cuda.current_stream(gts.device).cuda_stream
        launches += 1
        rc = lib.iswm_binary_confusion(
            gts.data_ptr(), _KINDS[gts.dtype], preds.data_ptr(), _KINDS[preds.dtype],
            gts.numel(), partials.data_ptr(), out.data_ptr(), stream,
        )
    if rc:
        raise RuntimeError("binary_confusion_matrix launch failed: "
                           f"{lib.iswm_cuda_error_string(rc).decode()}")
    return out

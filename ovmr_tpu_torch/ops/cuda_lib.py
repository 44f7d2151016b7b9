"""Build and load the hand-written Hopper kernels under ``ovmr_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`. The
build runs on first use: one ``nvcc`` per source, all started together,
into ``build/ovmr_tpu_torch_kernels/`` at the root of the checkout. A
library's file name carries a hash of its sources and flags, so an edited
source builds anew and an unchanged one loads straight away.

Nothing here runs at import time: the CPU tests import every module, and
this machine-independent module must not look for ``nvcc`` or a card
until a kernel is launched.

The launch counts live here too: each kernel wrapper calls
:func:`count_launch` where it launches its kernel, and nowhere else, so a
run can show that its main path went through the kernels, and at which
input shapes (:data:`LAUNCH_SHAPES`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from collections import Counter
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ovmr_tpu_torch_kernels"
SOURCES = ("block_fused", "block_fused_bwd", "attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

LAUNCHES: Dict[str, int] = {
    "fused_attn_half": 0,
    "fused_attn_half_masked": 0,
    "attn_core": 0,  # launched by K1 and K7 between their projections
    "fused_mlp_half": 0,
    "fused_mlp_half_chunked": 0,
    "fused_attention": 0,
    "attn_half_bwd_dx": 0,
    "attn_half_bwd_dx_masked": 0,
    "mlp_half_bwd_dx": 0,
    "tp_attn_half_partial": 0,
    "tp_attn_half_partial_masked": 0,
    "tp_mlp_half_partial": 0,
    "gemm_wgmma": 0,  # the bf16/fp16 products of K1-K5, K7 and K8, by name only
    # K3's attention-backward core, by route: one launch for short heads,
    # the query-tiled pair otherwise (counted once a call)
    "attn_bwd_core_short": 0,
    "attn_bwd_core_tiled": 0,
}
# launches by (kernel, shape of its first input, dtype name); the
# tensor-parallel partials add their shard's width to the shape, since one
# input shape runs different launches for shards of different widths, and
# the attention core is keyed (B, L, W, heads)
LAUNCH_SHAPES: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "block_fused": {
        # dtype, x, ln_g, ln_b, y, M, K, stream
        "ovmr_layer_norm": [_I, _P, _P, _P, _P, _I, _I, _P],
        # dtype, A, W, bias, residual, C, M, N, K, ldw, ldc, epilogue, stream
        "ovmr_gemm": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # dtype, A, W, bias, residual, C, M, N, K, ldw, ldc, epilogue, stream
        "ovmr_gemm_wgmma": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # dtype, x, bias, out, M, N, stream
        "ovmr_residual_bias": [_I, _P, _P, _P, _I, _I, _P],
        # dtype, qkv, mask, out, B, L, D, H, stream
        "ovmr_attn_core": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "block_fused_bwd": {
        # dtype, A, W, bias, aux, C, M, N, K, epilogue, stream
        "ovmr_gemm_bwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # dtype, A, W, bias, aux, C, M, N, K, ldw, ldc, epilogue, stream
        "ovmr_gemm_wgmma_bwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # dtype, xln, c_fc_w, c_fc_b, g, c_proj_w, dh_pre, M, N, K, stream
        "ovmr_mlp_bwd_dh": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        # dtype, x, dxln, g, ln_g, out, M, K, stream
        "ovmr_ln_bwd": [_I, _P, _P, _P, _P, _P, _I, _I, _P],
        # dtype, qkv, dattn, mask, dqkv, stats, B, L, D, H, stream
        "ovmr_attn_bwd_core": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # dtype, qkv, dattn, mask, dqkv, B, L, D, H, stream
        "ovmr_attn_bwd_core_short": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "attention": {
        # dtype, q, k, v, mask, out, BH, L, Dh, stream
        "ovmr_fused_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    LAUNCH_SHAPES.clear()


def count_launch(name: str, x: torch.Tensor, shape=None) -> None:
    """One launch of ``name`` on ``x``, keyed by ``shape`` (``x.shape`` when
    omitted)."""
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[shape_key(name, x.shape if shape is None else shape, x.dtype)] += 1


def count_inner_launch(name: str) -> None:
    """One launch of ``name``, a kernel that runs inside another kernel
    wrapper's launches (the wgmma GEMM inside K1-K5, K7 and K8; K3's
    attention-backward core): counted by name only, since its caller's
    :data:`LAUNCH_SHAPES` entry fixes its shapes."""
    LAUNCHES[name] += 1


def shape_key(name: str, shape, dtype: torch.dtype) -> Tuple[str, Tuple[int, ...], str]:
    return name, tuple(shape), str(dtype).removeprefix("torch.")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); cannot build kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library, in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure.
    The compiler's register and spill report is kept beside each library
    as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    nvcc = _nvcc()
    jobs = []
    for name in SOURCES:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, target, tmp, proc))
    failures = []
    for name, target, tmp, proc in jobs:
        output, _ = proc.communicate()
        target.with_suffix(".log").write_text(output)
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{output}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent builder sees all or nothing
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - start


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with argtypes set."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if not _target(name).exists():
        build_all()
    lib = ctypes.CDLL(str(_target(name)))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ovmr_error_string.argtypes = [ctypes.c_int]
    lib.ovmr_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (refused launch, bad
    configuration); a fault during the run shows at the next synchronise."""
    if status != 0:
        msg = lib.ovmr_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"kernels take float32, bfloat16 or float16, not {dtype}") from None


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card (what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    building a Stream object, whose cost counts where a call is bound by
    the host's time to issue it, as K6's is)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` where ``device`` is not the current
    card, else no context switch: a launcher runs on the current device,
    and a wrapper whose host time bounds it (K6) skips the switch's cost
    where it has nothing to do."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def require_no_grad(what: str, *tensors) -> None:
    """A raw kernel wrapper writes into fresh buffers through ctypes, so its
    result carries no ``grad_fn``: refuse a tensor that autograd is tracking
    instead of dropping its gradient. Inside a ``torch.autograd.Function``
    (where grad mode is off) the wrappers pass."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{what}: a tensor requires grad, and this kernel wrapper records no "
            "autograd graph; call it through its differentiable entry "
            "(fused_residual_block, fused_attention) or under torch.no_grad()"
        )


def require_cuda_args(what: str, dtype: torch.dtype, device: torch.device, **tensors) -> None:
    """Every tensor a kernel reads: on ``device``, of ``dtype`` (an fp32
    additive mask excepted, by the caller), contiguous, 16-byte aligned."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")

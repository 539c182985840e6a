"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
per source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The build runs at first use, in
the process that first launches a kernel, into ``wav2vec_s_tpu_torch/_build/``
(git-ignored); the library's file name carries a hash of the sources (the
``*.cuh`` headers they include too) and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing here runs at
import time.

The attention families (chunk attention, flash attention) come in two kernel
sets; ``kernel_path`` is the one rule that chooses between them, and
``aligned_kernel_path`` adds the tensor-core set's alignment check.  The
transducer lattices come in two sets too, chosen by
``ops/transducer/kernels.lattice_path``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the two kernel sets of the attention families: ``csrc/*_mma.cu`` (bf16
#: ``mma.sync`` tiles) and the f32 FMA kernels beside them
TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"
MMA_HEAD_WIDTHS = (32, 64, 128)      # instantiated in csrc/*_mma.cu

_lib = None
#: seconds the last build took (None: loaded without building) and what
#: nvcc printed (ptxas register/spill report)
build_seconds = None
build_log = ""


_TEMPLATE_ARG = re.compile(r"Li(\d+)E|Lb([01])E|(f)|(d)|(13__nv_bfloat16)")


def kernel_path(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel set a CUDA call of an attention wrapper runs: the
    tensor-core set for bfloat16 with a head width it is instantiated for,
    else the CUDA-core set."""
    if dtype == torch.bfloat16 and head_dim in MMA_HEAD_WIDTHS:
        return TENSOR_CORE
    return CUDA_CORE


def aligned_kernel_path(dtype: torch.dtype, head_dim: int, tensors,
                        family: str) -> str:
    """``kernel_path``, checked: the tensor-core kernels copy 16 bytes at a
    time, so the ``tensors`` they stage must start on a 16-byte boundary."""
    path = kernel_path(dtype, head_dim)
    if path == TENSOR_CORE and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the tensor-core {family} kernels take 16-byte "
                         f"aligned tensors")
    return path


def _kernel_name(mangled: str) -> str:
    """``name<template arguments>`` of a mangled ``*_kernel`` entry point
    (``..19flash_dq_mma_kernelILi64ELb1EEEv..`` -> ``flash_dq_mma_kernel<64,
    true>``); the mangled name itself where that fails."""
    end = mangled.find("_kernel") + len("_kernel")
    for n in range(len("_kernel"), min(end, 99)):
        name, digits = mangled[end - n:end], str(n)
        if (mangled[end - n - len(digits):end - n] == digits
                and re.fullmatch(r"[A-Za-z_]\w*", name)):
            break
    else:
        return mangled
    args, pos = [], end + 1
    if mangled[end:pos] == "I":
        while (m := _TEMPLATE_ARG.match(mangled, pos)):
            number, flag, f32, f64, bf16 = m.groups()
            args.append(number or (flag and ("false", "true")[int(flag)])
                        or (f32 and "float") or (f64 and "double")
                        or "bfloat16")
            pos = m.end()
    return f"{name}<{', '.join(args)}>" if args else name


def ptxas_summary(log: str):
    """[(kernel, registers, bytes spilled)] from what ``nvcc -Xptxas -v``
    printed, in the order of the log."""
    out, name, spilled = [], None, 0
    for line in log.splitlines():
        if (m := re.search(r"Compiling entry function '(\w+)'", line)):
            name, spilled = _kernel_name(m.group(1)), 0
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                             r"loads", line)):
            spilled = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.append((name, int(m.group(1)), spilled))
            name = None
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def _build(sources, target: Path) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp, src.stem + ".o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]     # waits for every one
        build_log = "".join(logs)
        failed = [(src.name, p.returncode)
                  for src, p in zip(sources, procs) if p.returncode]
        if not failed:
            so = Path(tmp, "lib.so")
            link = subprocess.run([nvcc, "-shared", "-o", str(so),
                                   *map(str, objs)], capture_output=True,
                                  text=True)
            build_log += link.stdout + link.stderr
            if link.returncode:
                failed = [("link", link.returncode)]
        build_seconds = time.perf_counter() - t
        if failed:
            raise RuntimeError(f"nvcc failed {failed}:\n{build_log}")
        os.replace(so, target)       # atomic: a reader never sees half a file


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    major, minor = torch.cuda.get_device_capability()
    if (major, minor) != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); this "
                           f"device is sm_{major}{minor}")
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode() + p.read_bytes())
    target = BUILD_DIR / f"libw2vs_kernels_{h.hexdigest()[:16]}.so"
    if not target.exists():
        _build(sources, target)
    _lib = _bind(ctypes.CDLL(str(target)))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of every kernel entry point."""
    fn = lib.w2vs_chunk_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.w2vs_chunk_attention_mma             # ... and kv_cap after t0
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # (seed, offset, base, heads, threshold, keep scale) of the attention
    # dropout
    drop = [ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_ulonglong,
            ctypes.c_int, ctypes.c_uint, ctypes.c_double]
    # the CUDA-core and the tensor-core kernels share their signatures
    for fn in (lib.w2vs_flash_attention, lib.w2vs_flash_attention_mma):
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + drop
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for fn in (lib.w2vs_flash_attention_bwd,
               lib.w2vs_flash_attention_bwd_mma):
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + drop
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    # q, q's row stride, k, v, (lo, stride), (hi, stride), (plane, two
    # strides), mask value, scale, out, T, N, D, H, dtype code
    fn = lib.w2vs_decode_attention
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2
                   + [ctypes.c_void_p, ctypes.c_int] * 2
                   + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.w2vs_dropout
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_uint,
                   ctypes.c_double, ctypes.c_int, ctypes.c_ulonglong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.w2vs_transducer_alphas
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.w2vs_transducer_betas
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.w2vs_transducer_affine_rows
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # the warp set of the lattice kernels (csrc/transducer_warp.cu) and the
    # fused walks of both sets; a length tensor comes as (pointer, 1 if
    # int64 else 0), the delay values as (pointer, three element strides)
    lens = [ctypes.c_void_p, ctypes.c_int] * 2
    dv = [ctypes.c_void_p] + [ctypes.c_longlong] * 3
    shape = [ctypes.c_int] * 3
    for name, args in (
            ("alphas", [ctypes.c_void_p] * 3 + shape),
            ("betas", [ctypes.c_void_p] * 2 + lens + [ctypes.c_void_p]
             + shape),
            ("affine_rows", [ctypes.c_void_p] * 4 + shape + [ctypes.c_int]),
            ("alphas_delay", [ctypes.c_void_p] * 2 + dv
             + [ctypes.c_void_p] * 2 + shape),
            ("betas_delay", [ctypes.c_void_p] * 2 + lens + dv
             + [ctypes.c_void_p] * 2 + shape)):
        names = [f"w2vs_lattice_warp_{name}"]
        if name.endswith("_delay"):
            names.append(f"w2vs_transducer_{name}")
        for full in names:
            fn = getattr(lib, full)
            fn.argtypes = args + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib

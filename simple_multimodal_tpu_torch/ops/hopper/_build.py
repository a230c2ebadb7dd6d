"""Build and load the port's Hopper kernels (``csrc/*.cu``).

Each ``.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes``. The build runs at first use,
into ``build/hopper`` at the checkout root (or ``$SMM_TORCH_BUILD_DIR``),
keyed by a hash of the sources and the flags and
guarded by a file lock, so concurrent first users build it once.

Nothing here runs at import time: the CPU tests import every module of the
port on machines with no ``nvcc`` and no GPU.
"""
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
ROW_BLOCKS, ROW_WARPS = 264, 8  # csrc/gemm.cuh kRowBlocks, kRowWarps

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_DROP = [_P, _U, _F]              # seed (device int32 [1] or null), threshold, 1/(1-rate)
_DROP2 = [_P, _U, _F, _I, _U, _F, _I]  # seed, then (threshold, scale, on) for mid and out
# argtypes of every C entry point: pointers and the stream as c_void_p so
# ctypes never truncates them to 32 bits.
SIGNATURES = {
    "smm_attention_block": [_I] + [_P] * 11 + [_F] + [_I] * 5 + _DROP + [_P] * 5,
    "smm_attention_block_bwd": [_I] + [_P] * 12 + [_F] + [_I] * 5 + _DROP + [_P] * 11,
    "smm_ffn_block": [_I] + [_P] * 7 + [_F] + [_I] * 6 + _DROP2 + [_P] * 5,
    "smm_ffn_block_bwd": [_I] + [_P] * 10 + [_F] + [_I] * 6 + _DROP2 + [_P] * 11,
    # ..., out, stats [2, B*H*S] or null, stream
    "smm_deberta_attention": [_I, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                              _I, _I, _I, _I] + _DROP + [_P] * 3,
    # ..., gy, ctx, stats, delta, dq, dk, dv, g_rel, the two fold CSRs, rows, dpos_k, dpos_q,
    # stream
    "smm_deberta_attention_bwd": [_I, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I]
                                 + _DROP + [_P] * 12 + [_I] + [_P] * 3,
    # q, k, v, out, stats [2, B, H, Sq], bias, host strides; B, Sq, Sk, H, D; stream
    "smm_flash_attention": [_I] + [_P] * 7 + [_I] * 5 + [_P],
    # q, k, v, out, dout, stats [2, B, H, Sq], bias, delta, dq, dk, dv, ds, host strides
    "smm_flash_attention_bwd": [_I] + [_P] * 13 + [_I] * 5 + [_P],
    # dtype; wav, w, gamma, beta, part, coef, out; B, T, C, K, stride, nb; eps; stream
    "smm_wav_frontend_fwd": [_I] + [_P] * 7 + [_I] * 6 + [_F, _P],
    # dtype; wav, w, gamma, beta, coef, gy, part_a, co, dgb, part_b, dw, dxt, dwav;
    # B, T, C, K, stride, nb; stream
    "smm_wav_frontend_bwd": [_I] + [_P] * 13 + [_I] * 6 + [_P],
    # dtype, pass (0 stats, 1 apply, 2 backward sums, 3 backward gradients), dwav, stride, C ->
    # bytes of dynamic shared memory
    "smm_wav_frontend_smem": [_I] * 5,
    # which (0 forward, 1 dq, 2 dk/dv, 3 forward with dropout), D -> bytes of dynamic shared memory
    "smm_flash_wgmma_smem": [_I, _I],
    # a, lda, w, ldw, bias, res, ldr, res_f32, out, ldc, out_f32, act, aux; seed, thresh,
    # scale, salt, S; M, N, K; stream
    "smm_gemm": [_P, _I, _P, _I, _P, _P, _I, _I, _P, _I, _I, _I, _P] + _DROP + [_I] * 5 + [_P],
    # a, lda, w, ldw, bias, res, ldr, out, ldc, aux; M, N, K -> 0 (WMMA) or the wgmma tile width
    "smm_gemm_route": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _I],
    # tile width -> bytes of dynamic shared memory
    "smm_gemm_wgmma_smem": [_I],
    # a, dy0, w1t, b1, w2t; M, E, F, S; seed, thresh, scale; h, dhp, part, db1; stream
    "smm_ffn_bwd_mm": [_P] * 5 + [_I] * 4 + _DROP + [_P] * 5,
    # dtype, E, F -> 1 (the wgmma chain) or 0 (gemm.cuh's chain)
    "smm_ffn_bwd_route": [_I, _I, _I],
    # -> the two-product kernel's dynamic shared memory
    "smm_ffn_bwd_wgmma_smem": [],
    # dy (f32), x, g; eps; M, E; add, dx, part, dln; stream
    "smm_ln_bwd": [_P] * 3 + [_F] + [_I] * 2 + [_P] * 5,
    # dtype, head width, rel (0 attention_block's backward, 1 deberta_attention both ways) ->
    # 1 (the wgmma kernels) or 0 (attention_bwd.cuh, attention.cuh)
    "smm_attention_wgmma_route": [_I, _I, _I],
    # which (0 dq, 1 dk/dv, 2 the re-run forward) -> bytes of dynamic shared memory of
    # deberta_attention's wgmma backward kernels
    "smm_deberta_bwd_wgmma_smem": [_I],
    # dtype; x, w (the tap layout), bias (f32) or null, y; B, L, E, G, K, pad; stream
    "smm_pos_conv": [_I] + [_P] * 4 + [_I] * 6 + [_P],
    # channels a group -> the wgmma width it is padded to, or 0
    "smm_pos_conv_width": [_I],
    # wgmma width -> bytes of dynamic shared memory of pos_conv_wgmma_kernel
    "smm_pos_conv_smem": [_I],
    # base, rows, K, repetitions -> host nanoseconds per tensor map
    "smm_tensor_map_ns": [_P, _I, _I, _I],
    # grads, numel, chunk_leaf, chunk_begin; n_leaves, n_chunks, chunk; partial, ticket, norms,
    # stream
    "smm_foreach_sumsq": [_P] * 4 + [_I] * 3 + [_P] * 4,
    # grads, params, mu, nu, backbone, numel, chunk_leaf, chunk_begin; n_chunks, chunk; norm;
    # clip, lr, b1, b2, 1 - b1, 1 - b2, the two bias corrections, eps, wd, backbone scale; stream
    "smm_foreach_adamw": [_P] * 8 + [_I] * 2 + [_P] + [_F] * 11 + [_P],
    # the routed experts (moe_experts_wgmma.cu): pointer table of 3n f32 weights, n, E, F, w1s,
    # w2s, stream
    "smm_moe_cast": [_P] + [_I] * 3 + [_P] * 3,
    # h, weights, dout, entry, counts, poff; n, k, E, rows; xs, ws, dys; stream
    "smm_moe_gather": [_P] * 6 + [_I] * 4 + [_P] * 4,
    # mode; a, b, gu, ws, out0, out1, part, poff; n, rows, E, F; stream
    "smm_moe_gemm": [_I] + [_P] * 8 + [_I] * 4 + [_P],
    # ys, pos; T, k, E; out; stream
    "smm_moe_combine": [_P] * 2 + [_I] * 3 + [_P] * 2,
    # dxs, part, pos; T, k, E, F; dh, dweights; stream
    "smm_moe_token_grad": [_P] * 3 + [_I] * 4 + [_P] * 3,
    # -> bytes of dynamic shared memory of moe_gemm_kernel
    "smm_moe_gemm_smem": [],
    # N; a, bt, v, c, o; stream
    "smm_hopper_selftest_mma": [_I] + [_P] * 6,
    # swizzle bytes; src, out; rows, cols, r0, c0; stream
    "smm_hopper_selftest_swizzle": [_I, _P, _P] + [_I] * 4 + [_P],
}

_lib = None
build_info = {}  # seconds and compiler log of the build this process loaded


def build_dir() -> Path:
    env = os.environ.get("SMM_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parents[1] / "build" / "hopper"


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the Hopper kernels "
                       "cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _check_device():
    if not torch.cuda.is_available():
        raise RuntimeError("the Hopper kernels need a CUDA device")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(f"the Hopper kernels are built for sm_90a; this "
                           f"device has compute capability {cap}")


def _compile(out_dir: Path, so: Path) -> None:
    """One nvcc per source, all running at once, then one link."""
    nvcc = find_nvcc()
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (c.stem + ".o") for c in cu]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", str(o), str(c)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c, o in zip(cu, objs)]
        logs = [f"== {c.name}\n" + p.communicate()[0] for c, p in zip(cu, procs)]
        failed = [c.name for c, p in zip(cu, procs) if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                                   "-o", str(Path(tmp) / so.name), *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append("== link\n" + link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append("link")
        build_info["seconds"] = time.perf_counter() - t0
        build_info["log"] = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n" + build_info["log"])
        os.replace(Path(tmp) / so.name, so)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    _check_device()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libsmm_hopper_{_key()}.so"
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            _compile(out_dir, so)
        else:
            build_info.setdefault("seconds", 0.0)
            build_info.setdefault("log", "cached")
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.smm_error_string.argtypes = [_I]
    lib.smm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = lib.smm_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err}: {msg}")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the Hopper kernels take float32 or bfloat16, got {t.dtype}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int:
    return None if t is None else t.data_ptr()


def row_partition(rows: int) -> tuple:
    """(rows per block, blocks) of the row kernels that leave per-block column
    partials (``csrc/gemm.cuh``: the LayerNorm backward, ``drop_cast_sum``):
    contiguous row ranges, as many as two 256-thread blocks on each of 132
    SMs, or one per eight rows where that is fewer."""
    if rows <= 0:
        return 1, 0
    want = min(-(-rows // ROW_WARPS), ROW_BLOCKS)
    per = -(-rows // want)
    return per, -(-rows // per)


def ln_bwd_blocks(rows: int) -> int:
    """Blocks of the LayerNorm backward: each writes one [2, E] partial of
    the scale/bias gradients, folded in block order afterwards."""
    return row_partition(rows)[1]

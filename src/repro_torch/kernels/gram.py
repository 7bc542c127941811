"""``gram``: G = U Uᵀ and c = U g in one pass over n, and ``gram_block``:
G_ab = U_a U_bᵀ and c_a = U_a g — the Hopper kernels.

``gram_cuda`` replaces ``repro.kernels.gram.gram_pallas``.  It has two
bodies, chosen from the inputs alone (:func:`_mma_eligible`): a call with U
and g both bf16, 1 <= K <= 127, n % 8 == 0 and 16-byte aligned pointers runs
on the bf16 tensor cores (``csrc/gram_mma.cu``), every other call on the f32
CUDA cores (``csrc/gram.cu``: K up to 64 in one piece and above it as one
grid slice per pair (a, b >= a) of 64-row blocks of U).  Each source says
what bounds it on the H100 and how its deterministic two-pass split
reduction is laid out; this module checks the inputs, allocates the outputs
and the per-block scratch with ``torch.empty``, and launches both passes on
the current stream without synchronising.  ``body_launches()`` tallies the
launches by body, so a run can show which body its path took.

``gram_block_cuda`` replaces ``repro.kernels.gram.gram_block_pallas``.  It
has two bodies as well, chosen from the inputs alone
(:func:`_block_mma_eligible`): a call with U_a, U_b and g all bf16,
1 <= Ka <= 64, 1 <= Kb <= 63, n % 8 == 0, 16-byte aligned pointers and row
strides that are multiples of 8 runs on the bf16 tensor cores
(``csrc/gram_block_mma.cu``), every other call on the shared cross-product
body of ``csrc/cross.cuh`` (``csrc/gram_block.cu``: any Ka and Kb, f32 or
bf16 each, no pad).  Both take A = U_a and B = [U_b; g] by pointer and row
stride, so U_a and U_b may be row blocks of one matrix.  No f32 operand is
rounded to bf16 to reach a tensor core.  ``block_body_launches()`` tallies
its launches by body.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from . import _build, cross
from .registry import count_launch

MAX_K = 64                # rows of U in one piece, and in each row block above
COLS_GRANULE = 128        # a block's column range is a multiple of this
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MMA_MAX_K = 127           # the tensor-core body's K: [U; g] in 128 rows
MMA_WARPS = 8             # warps of a block of the tensor-core body
MMA_STAGE_COLS = 128      # columns of one staged tile of [U; g]
BLOCK_MMA_MAX_KA = 64     # gram_block's tensor-core body: U_a in 64 rows
BLOCK_MMA_MAX_KB = 63     # and [U_b; g] in 64
_BODY_LAUNCHES = {"mma": 0, "cuda_core": 0}
_BLOCK_BODY_LAUNCHES = {"mma": 0, "cross": 0}


def _mma_eligible(updates: torch.Tensor, grad: torch.Tensor) -> bool:
    """Whether a call takes the tensor-core body: U and g both bf16,
    1 <= K <= 127, n >= 1 with n % 8 == 0 and both ``data_ptr()`` 16-byte
    aligned (every row of the contiguous U then starts 16-byte aligned).
    Reads only dtypes, shapes and pointers."""
    K, n = updates.shape
    return (updates.dtype == torch.bfloat16 and grad.dtype == torch.bfloat16
            and 1 <= K <= MMA_MAX_K and n >= 1 and n % 8 == 0
            and updates.data_ptr() % 16 == 0 and grad.data_ptr() % 16 == 0)


def body_launches() -> Dict[str, int]:
    """``{"mma": launches, "cuda_core": launches}`` since the last reset."""
    return dict(_BODY_LAUNCHES)


def reset_body_launches() -> None:
    for key in _BODY_LAUNCHES:
        _BODY_LAUNCHES[key] = 0


def mma_rows(K: int) -> int:
    """Rows Kp of the tensor-core body's [U; g], zero-padded to a multiple
    of 16 (its partial is Kp x Kp per block)."""
    return 16 * -(-(K + 1) // 16)


def mma_deal(K: int) -> List[List[Tuple[int, int]]]:
    """The (16 x 8) output tiles (i, j) of E Eᵀ, E = [U; g] in Kp rows, that
    each warp of a tensor-core block owns: the tiles with 8j + 7 >= 16i in
    row-major order, ceil(count / 8) consecutive ones a warp (as
    ``gram_mma_partial`` deals them)."""
    mt = mma_rows(K) // 16
    tiles = [(i, j) for i in range(mt) for j in range(2 * i, 2 * mt)]
    per_warp = -(-len(tiles) // MMA_WARPS)
    return [tiles[w * per_warp:(w + 1) * per_warp] for w in range(MMA_WARPS)]


def _block_mma_eligible(ua: torch.Tensor, ub: torch.Tensor,
                        grad: torch.Tensor) -> bool:
    """Whether a ``gram_block`` call takes the tensor-core body: U_a, U_b and
    g all bf16, 1 <= Ka <= 64, 1 <= Kb <= 63, n >= 1 with n % 8 == 0, every
    ``data_ptr()`` 16-byte aligned and both row strides multiples of 8
    entries (every row then starts 16-byte aligned).  Reads only dtypes,
    shapes, strides and pointers."""
    (Ka, n), Kb = ua.shape, ub.shape[0]
    return (all(t.dtype == torch.bfloat16 for t in (ua, ub, grad))
            and 1 <= Ka <= BLOCK_MMA_MAX_KA and 1 <= Kb <= BLOCK_MMA_MAX_KB
            and n >= 1 and n % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (ua, ub, grad))
            and ua.stride(0) % 8 == 0 and ub.stride(0) % 8 == 0)


def block_body_launches() -> Dict[str, int]:
    """``{"mma": launches, "cross": launches}`` of ``gram_block`` since the
    last reset."""
    return dict(_BLOCK_BODY_LAUNCHES)


def reset_block_body_launches() -> None:
    for key in _BLOCK_BODY_LAUNCHES:
        _BLOCK_BODY_LAUNCHES[key] = 0


def block_mma_rows(Ka: int, Kb: int) -> Tuple[int, int]:
    """Staged rows ``(RA, RB)`` of gram_block's tensor-core body: U_a
    zero-padded to a multiple of 16, [U_b; g] to a multiple of 8 (its
    partial is RA x RB per block)."""
    return 16 * -(-Ka // 16), 8 * -(-(Kb + 1) // 8)


def block_mma_deal(Ka: int, Kb: int) -> List[List[Tuple[int, int]]]:
    """The (16 x 8) output tiles (i, j) of U_a [U_b; g]ᵀ that each warp of
    a tensor-core block owns: all MA x NB tiles in row-major order,
    ceil(MA·NB / 8) consecutive ones a warp (as ``gram_block_mma_partial``
    deals them)."""
    ra, rb = block_mma_rows(Ka, Kb)
    tiles = [(i, j) for i in range(ra // 16) for j in range(rb // 8)]
    per_warp = -(-len(tiles) // MMA_WARPS)
    return [tiles[w * per_warp:(w + 1) * per_warp] for w in range(MMA_WARPS)]


def _check(updates: torch.Tensor, grad: torch.Tensor) -> None:
    if not (updates.is_cuda and grad.is_cuda):
        raise ValueError("gram_cuda needs CUDA tensors; got "
                         f"{updates.device} and {grad.device}")
    if updates.device != grad.device:
        raise ValueError(f"updates on {updates.device}, grad on {grad.device}")
    for name, t in (("updates", updates), ("grad", grad)):
        if t.dtype not in SUPPORTED_DTYPES:
            raise TypeError(f"gram_cuda: {name} dtype {t.dtype} not in "
                            f"{SUPPORTED_DTYPES}")
        if not t.is_contiguous():
            raise ValueError(f"gram_cuda: {name} must be contiguous")
    if updates.dim() != 2 or grad.dim() != 1:
        raise ValueError(f"gram_cuda: want updates (K, n) and grad (n,); got "
                         f"{tuple(updates.shape)} and {tuple(grad.shape)}")
    K, n = updates.shape
    if grad.shape[0] != n:
        raise ValueError(f"gram_cuda: updates have n={n}, grad {grad.shape[0]}")
    if K < 1:
        raise ValueError(f"gram_cuda: K={K} must be >= 1")
    if n < 1:
        raise ValueError("gram_cuda: n must be >= 1")


def grid(n: int, sm_count: int, blocks_per_sm: int,
         slices: int = 1) -> Tuple[int, int]:
    """``(num_blocks, cols_per_block)`` of each of ``slices`` grid slices:
    one resident wave of blocks in all (at most ``blocks_per_sm`` on each
    SM), each over a contiguous range of whole granules."""
    granules = -(-n // COLS_GRANULE)
    blocks = max(1, min(blocks_per_sm * sm_count // slices, granules))
    cols = -(-granules // blocks) * COLS_GRANULE
    return -(-n // cols), cols


def row_slices(K: int) -> int:
    """Grid slices: one per pair (a, b >= a) of the nb row blocks of U of up
    to ``MAX_K`` rows, nb(nb + 1)/2 (1 up to ``MAX_K``)."""
    nb = -(-K // MAX_K)
    return nb * (nb + 1) // 2


def scratch_rows(K: int) -> int:
    """Rows of the widest slice's partial: the extended matrix [U; g] padded
    to a multiple of 4 up to ``MAX_K``, else two row blocks (a cross slice,
    U_a against U_b)."""
    return (K + 1 + 3) // 4 * 4 if K <= MAX_K else 2 * MAX_K


@functools.lru_cache(maxsize=None)
def _resident(config_fn: str, dims: Tuple[int, ...],
              device_index: int) -> Tuple[int, int]:
    """``(blocks resident per SM, dynamic shared memory bytes per block)``
    that the library's ``config_fn`` reports for a partial kernel."""
    lib = _build.load_library()
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = getattr(lib, config_fn)(*dims, ctypes.byref(blocks),
                                     ctypes.byref(smem))
    _build.check(lib, rc, f"{config_fn} occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"{config_fn}: the partial kernel cannot be "
                           f"resident for {dims}")
    return blocks.value, smem.value


def launch_config(K: int, u_bf16: bool, g_bf16: bool,
                  device_index: int) -> Tuple[int, int]:
    """:func:`_resident` of the gram.cu partial kernel the launch picks for
    this K and these dtypes."""
    return _resident("gram_launch_config", (K, int(u_bf16), int(g_bf16)),
                     device_index)


def mma_launch_config(K: int, device_index: int) -> Tuple[int, int]:
    """:func:`_resident` of gram's tensor-core partial kernel for this K."""
    return _resident("gram_mma_launch_config", (K,), device_index)


def block_mma_launch_config(Ka: int, Kb: int,
                            device_index: int) -> Tuple[int, int]:
    """:func:`_resident` of gram_block's tensor-core partial kernel for these
    Ka, Kb."""
    return _resident("gram_block_mma_launch_config", (Ka, Kb), device_index)


def gram_cuda(updates: torch.Tensor, grad: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``updates (K, n)``, ``grad (n,)`` (f32 or bf16, contiguous, on one
    CUDA device) → ``(G (K, K) f32, c (K,) f32)``."""
    _check(updates, grad)
    K, n = updates.shape
    dev = updates.device
    u_bf16 = updates.dtype == torch.bfloat16
    g_bf16 = grad.dtype == torch.bfloat16
    mma = _mma_eligible(updates, grad)
    if mma:
        per_sm, _ = mma_launch_config(K, dev.index)
        slices, R = 1, mma_rows(K)
    else:
        per_sm, _ = launch_config(K, u_bf16, g_bf16, dev.index)
        slices, R = row_slices(K), scratch_rows(K)
    num_blocks, cols = grid(n, _build.sm_count(dev.index), per_sm, slices)
    out = torch.empty((K * K + K,), dtype=torch.float32, device=dev)
    G, c = out[:K * K].view(K, K), out[K * K:]
    partial = torch.empty((slices * num_blocks * R * R,), dtype=torch.float32,
                          device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if mma:
            rc = lib.gram_mma_launch(
                updates.data_ptr(), grad.data_ptr(), partial.data_ptr(),
                partial.numel(), G.data_ptr(), c.data_ptr(), K, n,
                num_blocks, cols, stream)
        else:
            rc = lib.gram_launch(
                updates.data_ptr(), grad.data_ptr(), partial.data_ptr(),
                partial.numel(), G.data_ptr(), c.data_ptr(), K, n,
                int(u_bf16), int(g_bf16), num_blocks, cols, stream)
    _build.check(lib, rc, "gram")
    count_launch("gram", "cuda")
    _BODY_LAUNCHES["mma" if mma else "cuda_core"] += 1
    return G, c


def gram_block_cuda(ua: torch.Tensor, ub: torch.Tensor, grad: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ua (Ka, n)``, ``ub (Kb, n)`` (any row stride, unit-strided columns)
    and ``grad (n,)``, f32 or bf16 each, on one CUDA device →
    ``(G_ab (Ka, Kb), c_a (Ka,))`` f32, on the tensor-core body when
    :func:`_block_mma_eligible` holds and on cross.cuh's otherwise."""
    dev = ua.device
    lda = cross.row_stride("gram_block_cuda", "ua", ua, dev)
    ldb = cross.row_stride("gram_block_cuda", "ub", ub, dev)
    if grad.dim() != 1:
        raise ValueError(f"gram_block_cuda: grad must be 1-D, got shape "
                         f"{tuple(grad.shape)}")
    cross.row_stride("gram_block_cuda", "grad", grad[None, :], dev)
    (Ka, n), (Kb, nb) = ua.shape, ub.shape
    if nb != n or grad.shape[0] != n:
        raise ValueError(f"gram_block_cuda: operands disagree on n: {n}, {nb} "
                         f"and {grad.shape[0]}")
    if Ka < 1 or Kb < 1:
        raise ValueError(f"gram_block_cuda: Ka={Ka} and Kb={Kb} must be >= 1")
    out = torch.empty((Ka * Kb + Ka,), dtype=torch.float32, device=dev)
    G, c = out[:Ka * Kb].view(Ka, Kb), out[Ka * Kb:]
    if n == 0:
        out.zero_()
        return G, c
    mma = _block_mma_eligible(ua, ub, grad)
    lib = _build.load_library()
    if mma:
        per_sm, _ = block_mma_launch_config(Ka, Kb, dev.index)
        num_blocks, cols = grid(n, _build.sm_count(dev.index), per_sm)
        ra, rb = block_mma_rows(Ka, Kb)
        partial = torch.empty((num_blocks * ra * rb,), dtype=torch.float32,
                              device=dev)
        with torch.cuda.device(dev):
            rc = lib.gram_block_mma_launch(
                ua.data_ptr(), lda, Ka, ub.data_ptr(), ldb, Kb,
                grad.data_ptr(), n, partial.data_ptr(), partial.numel(),
                num_blocks, cols, G.data_ptr(), c.data_ptr(),
                cross.stream_of(dev))
    else:
        partial, num_blocks, cols = cross.scratch("gram_block_launch_config",
                                                  (Ka, Kb), n, dev)
        bf16 = torch.bfloat16
        with torch.cuda.device(dev):
            rc = lib.gram_block_launch(
                ua.data_ptr(), lda, int(ua.dtype == bf16), Ka,
                ub.data_ptr(), ldb, int(ub.dtype == bf16), Kb,
                grad.data_ptr(), int(grad.dtype == bf16), n,
                partial.data_ptr(), partial.numel(), num_blocks, cols,
                G.data_ptr(), c.data_ptr(), cross.stream_of(dev))
    _build.check(lib, rc, "gram_block")
    count_launch("gram_block", "cuda")
    _BLOCK_BODY_LAUNCHES["mma" if mma else "cross"] += 1
    return G, c

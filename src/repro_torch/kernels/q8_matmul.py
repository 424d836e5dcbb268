"""int8 x int8 matmul on gathered q8_block codes, on the card.

Replaces ``repro/kernels/q8_matmul.py::q8_matmul`` (``_q8mm_kernel``,
launched at ``:126``): the serve path with ``param_store="q8_block"`` and
``serve_quant_matmul=True`` keeps each eligible gathered layer weight in
int8 from the all-gather through the matmul.  The per-block weight scale
is folded into the activation, the scaled activation is quantized per row,
int8 x int8 products accumulate exactly in int32 and the sum is rescaled
by the activation's row scale.  The kernel is ``csrc/q8_matmul.cu``, built
by ``kernels.build`` and called through its C launcher, one count a call:
one launch at decode (M <= ``DECODE_MAX_M``), the row quantization and the
``wgmma`` GEMM at prefill; its plain PyTorch version is
``kernels.ref.q8_matmul_ref``.

Scale algebra (the reference's).  A (K, N) weight is stored row-major in
the flat buffer, so quant block ``b`` covers flat elements
[b*block, (b+1)*block) and a dequant scale varies along the contraction
index k.  Two layouts make it separable per output-column group j:

  * case A -- ``N % block == 0``: row k holds nj = N/block blocks; block j
    of row k covers columns [j*block, (j+1)*block), s(k, j) =
    scales[k*nj + j].
  * case B -- ``block % N == 0``: one block spans r = block/N whole rows,
    s(k) = scales[k // r] (nj = 1).  K need not be a multiple of r: a
    trailing partial block (ceil(K*N/block) scales) folds to per-row
    scales truncated at K.

Both reduce to scales arranged (nj, K) (``fold_scales``) and, per group j,
``y[:, cols_j] = rowquant(x * s[j]) @ codes[:, cols_j]`` rescaled by the
row scale.  Other shapes are ineligible (``quant_eligible``) and take the
per-tensor ``dequantize_into`` fallback (``core.dbuffer.unpack_quant``).

Parity class: ALLCLOSE vs the dense ``x @ dequantize(w)`` (the activation
row quantization is new error by design, about 1/254 relative per
element); the kernel is BITWISE against its plain version on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .blockwise_quant import FLOAT_DTYPES, _check_cuda, _raise_on
from ..quant.blockwise import _check_blocking, _check_scales

KERNEL = "q8_matmul"
# the int32 sum of K products of int8 values in [-127, 127] must not wrap
MAX_K = (2 ** 31 - 1) // (127 * 127)
# the row stride of the prefill's row-quantized activation scratch: K padded
# to one TMA box of the GEMM (csrc/q8_matmul.cu kKPad)
K_PAD = 128
# the most rows of x that take the one-launch decode regime; more take the
# prefill regime.  Set by measurement on the H100 (chip_smoke.py
# kernel_q8mm's crossover rows, PERF.md): at M = 16 the decode kernel still
# beats the prefill path at every gemma2-2b shape, and 16 is the most its
# register tile takes (csrc/q8_matmul.cu kDecodeMaxM).
DECODE_MAX_M = 16


def quant_eligible(shape: tuple[int, ...], block: int) -> bool:
    """Can a tensor of ``shape`` run the int8-GEMM path with this quant
    block?  2-D with a separable scale layout: N % block == 0 (case A) or
    block % N == 0 (case B; a trailing partial block is fine)."""
    if len(shape) != 2:
        return False
    k, n = shape
    return n % block == 0 or block % n == 0


def _no_layout(k: int, n: int, block: int) -> ValueError:
    return ValueError(
        f"q8_matmul: weight ({k}, {n}) has no separable scale layout for "
        f"block {block} (need N % block == 0 or block % N == 0)")


def fold_scales(scales_flat: torch.Tensor, k: int, n: int,
                block: int) -> torch.Tensor:
    """Flat row-major block scales -> the kernel's (nj, K) contract (see
    the module docstring).  PARITY: BITWISE (index moves only)."""
    if n % block == 0:
        nj = n // block
        return scales_flat.reshape(k, nj).T              # s[j, k]
    if block % n == 0:
        r = block // n
        # ceil(k/r) scales cover k rows; the overhang block's repeat is
        # truncated at k
        return torch.repeat_interleave(scales_flat, r)[:k].reshape(1, k)
    raise _no_layout(k, n, block)


def check_args(k: int, n: int, block: int, n_scales: int) -> None:
    """The reference's argument checks (``q8_matmul.py:103-116``), same
    ``ValueError`` texts, plus the int32 accumulator's depth limit."""
    if n % block == 0:
        _check_blocking(k * n, block, "q8_matmul")
        _check_scales(k * n, block, n_scales, "q8_matmul")
    elif block % n == 0:
        nb = -(-(k * n) // block)
        if n_scales != nb:
            raise ValueError(
                f"q8_matmul: expected {nb} block scales for ({k}, {n}) "
                f"with block {block}, got {n_scales}")
    else:
        raise _no_layout(k, n, block)
    if k > MAX_K:
        raise ValueError(
            f"q8_matmul: K={k} products of int8 values could overflow the "
            f"int32 accumulator (K * 127 * 127 must stay below 2**31; "
            f"K <= {MAX_K})")


class QuantTensor:
    """A 2-D weight as int8 ``codes`` (K, N) + flat f32 block ``scales``,
    as unpacked from a gathered q8_block buffer
    (``core.dbuffer.DBuffer.unpack_quant``).  Model code multiplies through
    ``layers.dense`` -> ``ops.q8_matmul``, so the dense weight never
    materializes.  A plain class: the port has no pytrees."""

    __slots__ = ("codes", "scales", "block")

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor,
                 block: int):
        self.codes = codes
        self.scales = scales
        self.block = int(block)

    @property
    def shape(self):
        return self.codes.shape

    @property
    def ndim(self) -> int:
        return self.codes.ndim

    def __repr__(self):
        return (f"QuantTensor(shape={tuple(self.codes.shape)}, "
                f"block={self.block})")


def q8_slice_cols(qt: QuantTensor, start: int, width: int):
    """Columns [start, start + width) of a (K, N) QuantTensor without
    densifying, where the scale layout permits (the reference's, for an
    integer ``start``):

      * case B (``block % N == 0``): any slice, re-expressed with per-row
        scales (new block = width), the overhang block's repeat truncated
        at K;
      * case A (``N % block == 0``): whole-block slices only (``start`` and
        ``width`` multiples of the block).

    Returns the sliced QuantTensor (contiguous copies, as the reference's
    ``dynamic_slice``), or None when the slice is not scale-representable
    (the caller falls back to ``layers.to_dense``)."""
    k, n = qt.codes.shape
    block = qt.block
    start, width = int(start), int(width)
    if not 0 < width <= n:
        raise ValueError(
            f"q8_slice_cols: width {width} out of range for N={n}")
    if block % n == 0:
        r = block // n
        row_scales = torch.repeat_interleave(qt.scales, r)[:k]
        codes = qt.codes[:, start:start + width].contiguous()
        return QuantTensor(codes, row_scales, width)
    if n % block == 0 and width % block == 0:
        if start % block:
            return None
        nj = n // block
        codes = qt.codes[:, start:start + width].contiguous()
        s2 = qt.scales.reshape(k, nj)[:, start // block:
                                      (start + width) // block]
        return QuantTensor(codes, s2.reshape(-1), block)
    return None


def _launcher():
    fn = build.load(KERNEL).q8_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def regime_for(m: int) -> str:
    """The kernel's regime for ``m`` rows of x: ``"decode"`` (one launch,
    split K) or ``"prefill"`` (row quantization + ``wgmma`` GEMM)."""
    return "decode" if m <= DECODE_MAX_M else "prefill"


def q8_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
              block: int, out_dtype: torch.dtype,
              regime: str | None = None) -> torch.Tensor:
    """Launch the kernel: ``x`` (..., K) fp32 or bf16, ``codes`` (K, N)
    int8, ``scales`` the flat f32 block scales, all on one card (the
    arguments already checked by ``check_args``).  Returns (..., N) in
    ``out_dtype`` (fp32 or bf16), on the current stream, counted once.
    ``regime`` forces ``"decode"`` or ``"prefill"`` for a measurement;
    the serve path leaves it to ``regime_for(M)``.

      * decode: one launch, K split across a thread block cluster.
      * prefill: the row quantization into an (nj, M, K_PAD-padded K) int8
        scratch, then the GEMM.  TMA needs 16-byte aligned codes rows and
        column groups: codes that are not (a misaligned view, a group width
        N / nj not a multiple of 16) are first copied into an aligned
        buffer whose groups are padded to 16 columns."""
    k, n = codes.shape
    if x.dtype not in FLOAT_DTYPES or out_dtype not in FLOAT_DTYPES:
        raise ValueError(
            f"q8_matmul: x and out must be float32 or bfloat16, got "
            f"{x.dtype} and {out_dtype}")
    if codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(
            f"q8_matmul: codes must be int8 and scales float32, got "
            f"{codes.dtype} and {scales.dtype}")
    if x.shape[-1] != k:
        raise ValueError(
            f"q8_matmul: x last dim {x.shape[-1]} != codes rows {k}")
    lead = tuple(x.shape[:-1])
    xm = x.reshape(-1, k).contiguous()
    if n and codes.stride() != (n, 1):
        # the launcher reads rows N codes apart: a column view would be
        # read as other columns (``q8_slice_cols`` copies its slice)
        raise ValueError(
            f"q8_matmul: codes must be row-major (K, N) with rows {n} codes "
            f"apart, got strides {codes.stride()}")
    scales = scales.reshape(-1)
    _check_cuda("q8_matmul", x=xm, codes=codes, scales=scales)
    m = xm.shape[0]
    dev = x.device
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out.reshape(lead + (n,))
    if n % block == 0:
        nj, r = n // block, 0
    else:
        nj, r = 1, block // n
    regime = regime or regime_for(m)
    if regime not in ("decode", "prefill") or (
            regime == "decode" and m > DECODE_MAX_M):
        raise ValueError(f"q8_matmul: no {regime!r} regime for M={m}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ncols = n // nj
    kp, ldc, gstride = -(-k // K_PAD) * K_PAD, n, ncols
    a8 = rs = torch.empty(0, device=dev)        # unused at decode
    if regime == "prefill":
        a8 = torch.empty((nj, m, kp), dtype=torch.int8, device=dev)
        rs = torch.empty((nj, m), dtype=torch.float32, device=dev)
        if ncols % 16 or codes.data_ptr() % 16:
            gstride = -(-ncols // 16) * 16
            ldc = nj * gstride
            aligned = torch.empty((k, ldc), dtype=torch.int8, device=dev)
            aligned.view(k, nj, gstride)[:, :, :ncols].copy_(
                codes.view(k, nj, ncols))
            codes = aligned
    _raise_on(_launcher()(xm.data_ptr(), int(xm.dtype == torch.bfloat16),
                          codes.data_ptr(), ldc, gstride, scales.data_ptr(),
                          a8.data_ptr(), rs.data_ptr(), out.data_ptr(),
                          int(out_dtype == torch.bfloat16), m, k, n, nj, r,
                          kp, 1 if regime == "decode" else 2, stream),
              "q8_matmul")
    q8_matmul.launches += 1
    if regime == "decode":
        q8_matmul.decode_launches += 1
    else:
        q8_matmul.prefill_launches += 1
    return out.reshape(lead + (n,))


# calls of the kernel in this process (the main path's proof of route), and
# the same split by regime
q8_matmul.launches = 0
q8_matmul.decode_launches = 0
q8_matmul.prefill_launches = 0

"""Mamba2 SSD (state-space duality) chunked scan: a hand-written CUDA
kernel and its plain PyTorch versions.

Recurrence per row (one (batch, head) pair), in f32:

    S_t = a_t * S_{t-1} + B_t (x) u_t          (N x P state)
    y_t = C_t . S_t

Chunked form (``chunk`` positions, g = cumsum(log a) inside a chunk):

    y     = ((C B^T) o D) U + exp(g) * (C S_in)        D_ts = exp(g_t - g_s), s <= t
    S_out = exp(g_L) S_in + B^T diag(exp(g_L - g_s)) U

The kernel (``csrc/ssd_scan.cu``, built for ``sm_90a`` at first use by
:mod:`repro_torch.kernels.build`) runs the chunk loop inside one block per
(row, tile of 64 columns of P), keeps the state in registers and runs the
chunk's products on the tensor cores in bf16 with f32 sums, splitting
every f32 operand into bf16 terms. It takes chunks of at most
:data:`KERNEL_CHUNK` positions: the chunked form is the same function for
any chunk length, and only its rounding depends on it. Rows may share B and C: with ``heads``
rows per batch row the kernel reads B and C at row ``// heads``, so the
multi-head form (:func:`repro_torch.kernels.ops.ssd_scan_mh`) never
repeats them.

Plain versions, beside the kernel: the token-by-token recurrence
(:func:`ssd_scan_oracle`), the chunked form (:func:`ssd_scan_chunked`) and
the multi-head chunked form with shared B/C (:func:`ssd_scan_chunked_mh`).
They compute in float32, or in float64 when given float64. The split
model (:func:`ssd_scan_split_model`) computes the chunked form in float64
with the operands rounded and split where the kernel splits them: it
bounds the error the kernel's split adds.

A wrapper given CPU tensors runs the plain chunked form; given CUDA
tensors it launches the kernel on the current stream or raises: it never
falls back. Each launch adds one to ``LAUNCHES["ssd_scan"]``.

Gradients (:func:`ssd_scan`, :func:`ssd_scan_rows`): on CPU tensors
autograd runs through the plain chunked form. On CUDA tensors the scan is
an autograd function whose forward is the kernel and whose backward
recomputes the plain chunked form from the saved inputs and returns its
vector-Jacobian product, as the reference's custom VJP does
(``_ssd_bwd_rule``, plain ``jnp``): there is no backward kernel. B and C,
shared by the heads, get the sum of the heads' gradients.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build

#: the reference's default chunk length
CHUNK = 128
#: the kernel holds chunks of at most this many positions ...
MAX_CHUNK = 128
#: ... and states of at most this many rows (N); P is split into tiles of
#: 64 columns across blocks and has no cap. Larger inputs raise on CUDA
#: (``csrc/ssd_scan.cu``: one block's operands in 227 KB of shared memory,
#: its y rows and state in registers).
MAX_STATE = 128

#: the kernel walks chunks of min(chunk, KERNEL_CHUNK) positions
#: (``csrc/ssd_scan.cu``: two blocks' tiles on an SM)
KERNEL_CHUNK = 64

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"ssd_scan": 0}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    """Set the launch count to 0."""
    LAUNCHES["ssd_scan"] = 0


def _library() -> ctypes.CDLL:
    """Build/load ``csrc/ssd_scan.cu`` and declare its C interface."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("ssd_scan")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            ip = ctypes.POINTER(ctypes.c_int)
            lib.ssd_scan_launch.argtypes = [p, p, p, p, p, ll, ll, i, i, i,
                                            i, i, p]
            lib.ssd_scan_launch.restype = ctypes.c_int
            lib.ssd_scan_occupancy.argtypes = [i, i, i, ip, ip]
            lib.ssd_scan_occupancy.restype = ctypes.c_int
            lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
            lib.ssd_scan_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def kernel_occupancy(chunk: int, n: int,
                     dtype: torch.dtype) -> Tuple[int, int]:
    """(dynamic shared memory bytes a block, resident blocks an SM) of the
    kernel for ``chunk``, state size ``n`` and operand ``dtype`` on the
    current card."""
    lib = _library()
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    code = lib.ssd_scan_occupancy(chunk, n, int(dtype == torch.bfloat16),
                                  ctypes.byref(smem), ctypes.byref(blocks))
    if code != 0:
        raise RuntimeError(f"ssd_scan_occupancy failed: "
                           f"{lib.ssd_scan_error_string(code).decode()}")
    return smem.value, blocks.value


# ------------------------------------------------------------ plain versions

def _compute_dtype(u: torch.Tensor) -> torch.dtype:
    return torch.promote_types(u.dtype, torch.float32)


def ssd_scan_oracle(u: torch.Tensor, log_decay: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor,
                    chunk: int = 0) -> torch.Tensor:
    """The exact token-by-token recurrence. Shapes as :func:`ssd_scan`;
    ``chunk`` is ignored."""
    del chunk
    f = _compute_dtype(u)
    bh, L, p = u.shape
    n = b.shape[-1]
    uf, la, bf, cf = u.to(f), log_decay.to(f), b.to(f), c.to(f)
    state = torch.zeros((bh, n, p), dtype=f, device=u.device)
    ys = []
    for t in range(L):
        state = torch.exp(la[:, t])[:, None, None] * state \
            + bf[:, t, :, None] * uf[:, t, None, :]
        ys.append(torch.einsum("zn,znp->zp", cf[:, t], state))
    y = torch.stack(ys, dim=1) if ys else uf.new_zeros((bh, 0, p))
    return y.to(u.dtype)


def ssd_scan_chunked_mh(u: torch.Tensor, log_decay: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor,
                        chunk: int = CHUNK) -> torch.Tensor:
    """The chunked form with B/C shared across heads (Mamba2's single B/C
    group): the head axis stays inside the products, so B and C are never
    repeated per head.

    Shapes: u (B, H, L, P); log_decay (B, H, L); b, c (B, L, N).
    Returns y (B, H, L, P) in u's dtype.
    """
    bsz, h, L, p = u.shape
    n = b.shape[-1]
    f = _compute_dtype(u)
    pad = (-L) % chunk
    nc = (L + pad) // chunk
    uf = torch.nn.functional.pad(u.to(f), (0, 0, 0, pad))
    la = torch.nn.functional.pad(log_decay.to(f), (0, pad))
    bf = torch.nn.functional.pad(b.to(f), (0, 0, 0, pad))
    cf = torch.nn.functional.pad(c.to(f), (0, 0, 0, pad))
    uf = uf.reshape(bsz, h, nc, chunk, p)
    la = la.reshape(bsz, h, nc, chunk)
    bf = bf.reshape(bsz, nc, chunk, n)
    cf = cf.reshape(bsz, nc, chunk, n)

    g = torch.cumsum(la, dim=-1)                         # (B,H,NC,Lc)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=u.device).tril()
    seg = (g[..., :, None] - g[..., None, :]).masked_fill(~causal,
                                                          float("-inf"))
    dmat = torch.exp(seg)                                # 0 above the diagonal
    cb = torch.einsum("zctn,zcsn->zcts", cf, bf)         # shared across heads
    y_intra = torch.einsum("zhcts,zhcsp->zhctp", cb[:, None] * dmat, uf)

    carry_w = torch.exp(g[..., -1:] - g)                 # (B,H,NC,Lc)
    s_local = torch.einsum("zcsn,zhcsp->zhcnp", bf,
                           carry_w[..., None] * uf)
    a_chunk = torch.exp(g[..., -1])                      # (B,H,NC)
    state = torch.zeros((bsz, h, n, p), dtype=f, device=u.device)
    s_in = []
    for ci in range(nc):
        s_in.append(state)                               # INCOMING state
        state = a_chunk[..., ci, None, None] * state + s_local[:, :, ci]
    if s_in:
        y_inter = torch.exp(g)[..., None] * torch.einsum(
            "zctn,zhcnp->zhctp", cf, torch.stack(s_in, dim=2))
        y_intra = y_intra + y_inter
    y = y_intra.reshape(bsz, h, nc * chunk, p)
    return y[:, :, :L].to(u.dtype)


def ssd_scan_chunked(u: torch.Tensor, log_decay: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor,
                     chunk: int = CHUNK) -> torch.Tensor:
    """The chunked form on (BH, ·) operands (:func:`ssd_scan`'s shapes):
    the multi-head form with one head per row."""
    return ssd_scan_chunked_mh(u[:, None], log_decay[:, None], b, c,
                               chunk)[:, 0]


def _ssd_scan_plain(u, log_decay, b, c, chunk, heads):
    """Plain version of :func:`_ssd_scan`."""
    bh, L, p = u.shape
    y = ssd_scan_chunked_mh(u.reshape(bh // heads, heads, L, p),
                            log_decay.reshape(bh // heads, heads, L), b, c,
                            chunk)
    return y.reshape(bh, L, p)


def _split_terms(x: torch.Tensor, k: int) -> List[torch.Tensor]:
    """``x`` rounded to float32, then split into ``k`` bfloat16 terms (each
    the rounding of what the ones before leave), returned in float64."""
    rest = x.float()
    terms = []
    for _ in range(k):
        head = rest.bfloat16().float()
        terms.append(head.double())
        rest = rest - head
    return terms


def _split_einsum(eq: str, a: List[torch.Tensor],
                  b: List[torch.Tensor]) -> torch.Tensor:
    """The kernel's split product: the sum over term pairs (i, j) with
    i + j <= 2 of ``einsum(eq, a_i, b_j)``, in float64."""
    return sum(torch.einsum(eq, ai, bj) for i, ai in enumerate(a)
               for j, bj in enumerate(b) if i + j <= 2)


def ssd_scan_split_model(u: torch.Tensor, log_decay: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, chunk: int = CHUNK,
                         heads: int = 1) -> torch.Tensor:
    """A model of the CUDA kernel's rounding, on any device: the chunked
    form over chunks of min(chunk, :data:`KERNEL_CHUNK`) positions, as the
    kernel takes them, in float64 with each product's operands split into
    bfloat16 terms where the kernel splits them (u, B, C: one term for
    bfloat16 inputs, exact, three for float32 ones; the float32
    intermediates M = (C B^T) o D, the state S and w o U: hi + lo, three
    terms for float32 inputs), the cumulative log decays g and their
    differences in float32, and the state kept in float32 between chunks.

    It bounds the error that the split adds; it does not reproduce the
    kernel's result bit for bit (the kernel's sum orders, its cumsum of g
    and its exp2 differ). Shapes and result as :func:`_ssd_scan`."""
    kx, ki = (1, 2) if u.dtype == torch.bfloat16 else (3, 3)
    return _split_model(u, log_decay, b, c, chunk, heads, kx, ki)


def _split_model(u, log_decay, b, c, chunk, heads, kx, ki) -> torch.Tensor:
    """:func:`ssd_scan_split_model` with ``kx`` bf16 terms for the inputs
    and ``ki`` for the intermediates; each product sums the term pairs
    with i + j <= 2."""
    chunk = min(chunk, KERNEL_CHUNK)
    rows, L, p = u.shape
    bsz, n = rows // heads, b.shape[-1]
    uu = u.reshape(bsz, heads, L, p)
    la = log_decay.reshape(bsz, heads, L).float()
    y = torch.zeros((bsz, heads, L, p), dtype=torch.float64, device=u.device)
    state = torch.zeros((bsz, heads, n, p), dtype=torch.float32,
                        device=u.device)
    for t0 in range(0, L, chunk):
        t1 = min(t0 + chunk, L)
        g = torch.cumsum(la[..., t0:t1], dim=-1)        # (B, H, lc), f32
        cs = _split_terms(c[:, t0:t1], kx)
        bs = _split_terms(b[:, t0:t1], kx)
        us = _split_terms(uu[:, :, t0:t1], kx)
        causal = torch.ones((t1 - t0,) * 2, dtype=torch.bool,
                            device=u.device).tril()
        dmat = torch.exp((g[..., :, None] - g[..., None, :]).double()
                         .masked_fill(~causal, float("-inf")))
        m = _split_einsum("ztn,zsn->zts", cs, bs)[:, None] * dmat
        yc = _split_einsum("zhts,zhsp->zhtp", _split_terms(m, ki), us)
        if t0 > 0:
            yc = yc + torch.exp(g.double())[..., None] * _split_einsum(
                "ztn,zhnp->zhtp", cs, _split_terms(state, ki))
        y[:, :, t0:t1] = yc
        if t1 < L:
            g_last = g[..., -1:]
            wu = torch.exp((g_last - g).double())[..., None] \
                * uu[:, :, t0:t1].double()
            local = _split_einsum("zsn,zhsp->zhnp", bs,
                                  _split_terms(wu, ki))
            state = (torch.exp(g_last.double())[..., None] * state.double()
                     + local).float()
    return y.reshape(rows, L, p).to(u.dtype)


# ------------------------------------------------------------------ wrappers

def _check(u, log_decay, b, c, chunk, heads) -> None:
    """Shapes and devices, whatever the device."""
    if u.dim() != 3:
        raise ValueError(f"u must be (rows, L, P), got {tuple(u.shape)}")
    bh, L, _ = u.shape
    if heads < 1 or bh % heads:
        raise ValueError(f"{bh} rows do not split into heads of {heads}")
    if tuple(log_decay.shape) != (bh, L):
        raise ValueError(f"log_decay of shape {tuple(log_decay.shape)}, "
                         f"expected {(bh, L)}")
    if b.dim() != 3 or tuple(b.shape[:2]) != (bh // heads, L) \
            or b.shape != c.shape:
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must "
                         f"both be ({bh // heads}, {L}, N)")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    devices = {t.device for t in (u, log_decay, b, c)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no SSD scan for device {u.device}")


def _check_kernel(u, log_decay, b, c, chunk) -> None:
    """What the CUDA kernel takes: raises ``ValueError`` on anything else."""
    if u.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bfloat16 or float32 u, got "
                         f"{u.dtype}")
    if b.dtype != u.dtype or c.dtype != u.dtype:
        raise ValueError(f"b ({b.dtype}) and c ({c.dtype}) must have u's "
                         f"dtype ({u.dtype})")
    if log_decay.dtype != torch.float32:
        raise ValueError(f"log_decay must be float32, got {log_decay.dtype}")
    if not all(t.is_contiguous() for t in (u, log_decay, b, c)):
        raise ValueError("the kernel takes contiguous operands")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the CUDA kernel holds at most "
                         f"{MAX_CHUNK}")
    if b.shape[-1] > MAX_STATE:
        raise ValueError(f"state size N={b.shape[-1]}: the CUDA kernel "
                         f"holds at most {MAX_STATE}")


def _ssd_scan(u: torch.Tensor, log_decay: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, chunk: int, heads: int) -> torch.Tensor:
    """The SSD scan of rows ``u`` (R, L, P), ``log_decay`` (R, L) with B and
    C (R / heads, L, N) shared by each run of ``heads`` consecutive rows.
    Returns y (R, L, P) in u's dtype. The CUDA kernel works in chunks of
    min(chunk, :data:`KERNEL_CHUNK`) positions: the same function, but its
    rounding differs from the plain chunked form at a larger ``chunk``."""
    _check(u, log_decay, b, c, chunk, heads)
    if u.device.type == "cpu":
        return _ssd_scan_plain(u, log_decay, b, c, chunk, heads)
    _check_kernel(u, log_decay, b, c, chunk)
    rows, L, p = u.shape
    y = torch.empty_like(u)
    if rows == 0 or L == 0 or p == 0:
        return y
    dev = u.device
    with torch.cuda.device(dev):
        lib = _library()
        code = lib.ssd_scan_launch(
            ctypes.c_void_p(u.data_ptr()),
            ctypes.c_void_p(log_decay.data_ptr()),
            ctypes.c_void_p(b.data_ptr()), ctypes.c_void_p(c.data_ptr()),
            ctypes.c_void_p(y.data_ptr()), rows, L, p, b.shape[-1], chunk,
            heads, int(u.dtype == torch.bfloat16),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if code != 0:
        msg = lib.ssd_scan_error_string(code).decode()
        raise RuntimeError(f"ssd_scan launch failed: {msg} "
                           f"(cuda error {code})")
    LAUNCHES["ssd_scan"] += 1
    return y


class _SSDScan(torch.autograd.Function):
    """The kernel's forward (:func:`_ssd_scan`); the backward is the
    vector-Jacobian product of the plain chunked form, recomputed from the
    saved inputs."""

    @staticmethod
    def forward(ctx, u, log_decay, b, c, chunk, heads):
        ctx.chunk, ctx.heads = chunk, heads
        ctx.save_for_backward(u, log_decay, b, c)
        return _ssd_scan(u, log_decay, b, c, chunk, heads)

    @staticmethod
    def backward(ctx, grad_y):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = _ssd_scan_plain(*ins, ctx.chunk, ctx.heads)
        wanted = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, grad_y))
        return (*(next(grads) if t.requires_grad else None for t in ins),
                None, None)


def ssd_scan_rows(u: torch.Tensor, log_decay: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, chunk: int = CHUNK,
                  heads: int = 1) -> torch.Tensor:
    """:func:`_ssd_scan` (rows ``u`` (R, L, P), B and C (R / heads, L, N)
    shared by each run of ``heads`` rows), differentiable: CPU tensors run
    the plain chunked form under autograd; CUDA tensors launch the kernel,
    with the plain form's vector-Jacobian product as the backward."""
    if u.device.type == "cpu":
        return _ssd_scan(u, log_decay, b, c, chunk, heads)
    return _SSDScan.apply(u, log_decay, b, c, chunk, heads)


def ssd_scan(u: torch.Tensor, log_decay: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """Chunked SSD scan, differentiable (:func:`ssd_scan_rows`).

    Args:
      u:         (BH, L, P) dt-scaled inputs (bfloat16 or float32 on CUDA).
      log_decay: (BH, L) log a_t <= 0 (float32 on CUDA).
      b:         (BH, L, N) input projections (u's dtype on CUDA).
      c:         (BH, L, N) output projections (u's dtype on CUDA).
      chunk:     chunk length (the CUDA kernel works in chunks of
                 min(chunk, KERNEL_CHUNK) positions: the same function,
                 rounded as the chunked form at that length).

    Returns:
      y: (BH, L, P), same dtype as u.
    """
    return ssd_scan_rows(u, log_decay, b, c, chunk, heads=1)

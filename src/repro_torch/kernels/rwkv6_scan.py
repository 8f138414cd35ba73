"""The chunked RWKV6 wkv recurrence — port of ``repro/kernels/rwkv6_scan.py``
and of the chunk loop in ``repro/models/rwkv6.py::rwkv_time_mix``.

    o_t = r_t · (S_{t-1} + (u ⊙ k_t) ⊗ v_t),   S_t = diag(e^{logw_t}) S_{t-1} + k_t ⊗ v_t

``rwkv6_scan`` launches the hand-written CUDA kernels (``csrc/rwkv6_scan.cu``)
for CUDA tensors and takes the plain PyTorch version beside it only for
CPU tensors; any other device raises. On the card a call under grad with
an input that requires it goes through ``Rwkv6ScanFn``: the chunked route
at every S, its chunk states kept for the backward kernel's three launches
(``csrc/rwkv6_scan_bwd.cu``, counted in ``rwkv6_scan.launches_bwd``).
Without grad it routes by S, explicitly:

- S > 1 -> the chunked route: chunk states in parallel over (batch,
  head, chunk), a scan of the states down the chunks, then the outputs in
  parallel, the products on the tensor cores (3 × TF32); counted in
  ``rwkv6_scan.launches_chunked``;
- S = 1 (a decode step) -> the decode route, one small launch that reads
  and writes the state once; counted in ``rwkv6_scan.launches_decode``.

``rwkv6_scan.launches`` is their sum. Both take the chunkwise form of the
reference model's ``_chunk_body`` in chunks of ``chunk`` tokens, a ragged
last chunk included (the model would take one chunk of S tokens there:
the same function up to rounding), from an optional initial state S0.

r, k, v (f32 or bf16) and logw (f32, ≤ 0) are (B, H, S, hd) with hd
contiguous and any other strides; u is (H, hd). Returns o (B, H, S, hd)
f32, laid out in memory as (B, S, H, hd) (the model's layout), and
S_final (B, H, hd, hd) f32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.obs.profile import kernel_scope

DEFAULT_CHUNK = 64
MAX_CHUNK = MAX_HEAD_DIM = 64      # the kernel's shared-memory tiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# route: (entry point, argument types, launch counter)
ROUTES = {
    "chunked": ("rwkv6_scan_fwd", [ctypes.c_int] + [ctypes.c_void_p] * 10
                + [ctypes.c_longlong] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                "launches_chunked"),
    "decode": ("rwkv6_decode_fwd", [ctypes.c_int] + [ctypes.c_void_p] * 8
               + [ctypes.c_longlong] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
               "launches_decode"),
}


_ENTRIES = {entry: argtypes for entry, argtypes, _ in ROUTES.values()}
# the backward's library: r, k, v, logw, u, do, S_in, S_final, dS_final, its
# scratch (dS_out, decays, du partials), dr, dk, dv, dlogw, dS0; 9 × 3 strides
_BWD_ENTRIES = {"rwkv6_scan_bwd": [ctypes.c_int] + [ctypes.c_void_p] * 17
                + [ctypes.c_longlong] * 27 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}


def _check(r, k, v, logw, u, s0):
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"want r, k, v, logw (B, H, S, hd); got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(logw.shape)}")
    B, H, S, hd = r.shape
    if u.shape != (H, hd):
        raise ValueError(f"u must be (H, hd) = {(H, hd)}, got {tuple(u.shape)}")
    if s0 is not None and s0.shape != (B, H, hd, hd):
        raise ValueError(f"s0 must be {(B, H, hd, hd)}, got {tuple(s0.shape)}")
    return B, H, S, hd


def _chunk_body(r, k, v, logw, u, S_in):
    """One chunk, all heads, f32: r, k, v, logw (B, H, W, hd); S_in (B, H,
    hd, hd) -> (o (B, H, W, hd), S_out). The reference model's _chunk_body
    with heads ahead of time."""
    W = r.shape[2]
    c = torch.cumsum(logw, dim=2)                          # inclusive Σ log w
    c_excl = c - logw
    o = torch.einsum("bhwk,bhkv->bhwv", r * torch.exp(c_excl), S_in)
    # intra-chunk pairs j < t; the exponent is ≤ 0 on the causal pairs and
    # clamped at 0 so the masked ones cannot overflow
    diff = c_excl[:, :, :, None] - c[:, :, None, :, :]      # (B, H, T, J, hd)
    att = (r[:, :, :, None] * k[:, :, None] * torch.exp(diff.clamp_max(0.0))).sum(-1)
    tri = torch.tril(torch.ones((W, W), dtype=torch.bool, device=r.device), diagonal=-1)
    att = torch.where(tri, att, torch.zeros_like(att))
    diag = (r * (u[None, :, None, :] * k)).sum(-1)         # (B, H, W)
    o = o + torch.einsum("bhtj,bhjv->bhtv", att, v) + diag[..., None] * v
    c_tot = c[:, :, -1]                                    # (B, H, hd)
    k_dec = k * torch.exp(c_tot[:, :, None] - c)
    S_out = S_in * torch.exp(c_tot)[..., None] + torch.einsum("bhjk,bhjv->bhkv", k_dec, v)
    return o, S_out


def rwkv6_scan_plain(r, k, v, logw, u, *, chunk: int = DEFAULT_CHUNK,
                     s0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the chunk loop of the reference model."""
    B, H, S, hd = _check(r, k, v, logw, u, s0)
    rf, kf, vf, wf, uf = (t.float() for t in (r, k, v, logw, u))
    St = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
          if s0 is None else s0.float())
    o = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device).transpose(1, 2)
    for t0 in range(0, S, chunk):
        sl = slice(t0, min(S, t0 + chunk))
        o[:, :, sl], St = _chunk_body(rf[:, :, sl], kf[:, :, sl], vf[:, :, sl],
                                      wf[:, :, sl], uf, St)
    return o, St


def _chunk_grads(r, k, v, logw, u, S_in, dS_out, S_out, do):
    """One chunk's gradient, all heads, f32: r, k, v, logw, do (B, H, W, hd);
    S_in, dS_out (∂L/∂S_out) and S_out (B, H, hd, hd) -> (dr, dk, dv, dlogw,
    du (H, hd), dS_in). The derivation is in ``csrc/rwkv6_scan_bwd.cu``."""
    W = r.shape[2]
    c = torch.cumsum(logw, dim=2)
    c_excl = c - logw
    c_tot = c[:, :, -1]                                    # (B, H, hd)
    diff = c_excl[:, :, :, None] - c[:, :, None, :, :]      # (B, H, T, J, hd)
    tri = torch.tril(torch.ones((W, W), dtype=torch.bool, device=r.device), diagonal=-1)
    E = torch.where(tri[..., None], torch.exp(diff.clamp_max(0.0)), torch.zeros_like(diff))
    P = torch.einsum("bhte,bhje->bhtj", do, v)              # do_t · v_j
    Pd = torch.diagonal(P, dim1=2, dim2=3)[..., None]      # (B, H, W, 1)
    A = (r[:, :, :, None] * k[:, :, None] * E).sum(-1) + torch.diag_embed(
        (r * (u[None, :, None, :] * k)).sum(-1))
    k_dec = torch.exp(c_tot[:, :, None] - c)               # e^{c_{W-1} − c_j}
    dr_w = (torch.exp(c_excl) * torch.einsum("bhte,bhde->bhtd", do, S_in)
            + (P[..., None] * k[:, :, None] * E).sum(3))
    dk_w = (k_dec * torch.einsum("bhje,bhde->bhjd", v, dS_out)
            + (P[..., None] * r[:, :, :, None] * E).sum(2))
    dr = dr_w + u[None, :, None, :] * k * Pd
    dk = dk_w + u[None, :, None, :] * r * Pd
    dv = (torch.einsum("bhtj,bhte->bhje", A, do)
          + torch.einsum("bhjd,bhde->bhje", k * k_dec, dS_out))
    du = (r * k * Pd).sum((0, 2))
    # logw enters through the cumulative sums only: a reverse sum over the
    # chunk, S_out carrying the later chunks
    q, kap = r * dr_w, k * dk_w
    z = torch.flip(torch.cumsum(torch.flip(q - kap, (2,)), 2), (2,))
    dlogw = (dS_out * S_out).sum(-1)[:, :, None] + z - q
    dS_in = (torch.exp(c_tot)[..., None] * dS_out
             + torch.einsum("bhsd,bhse->bhde", r * torch.exp(c_excl), do))
    return dr, dk, dv, dlogw, du, dS_in


def rwkv6_scan_bwd_plain(r, k, v, logw, u, do, *, chunk: int = DEFAULT_CHUNK,
                         s0: Optional[torch.Tensor] = None,
                         ds_final: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the gradient, the chunked backward: the
    forward's chunk states from its chunk loop, then the chunks in reverse,
    dS carried from ``ds_final`` (or 0) -> (dr, dk, dv in r's type, dlogw,
    du (H, hd) and ds0, f32)."""
    B, H, S, hd = _check(r, k, v, logw, u, s0)
    rf, kf, vf, wf, uf, dof = (t.float() for t in (r, k, v, logw, u, do))
    St = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
          if s0 is None else s0.float())
    bounds = [(t0, min(S, t0 + chunk)) for t0 in range(0, S, chunk)]
    states = []
    for t0, t1 in bounds:
        states.append(St)
        _, St = _chunk_body(rf[:, :, t0:t1], kf[:, :, t0:t1], vf[:, :, t0:t1],
                            wf[:, :, t0:t1], uf, St)
    states.append(St)                                      # S_final
    dS = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
          if ds_final is None else ds_final.float())
    grads = [torch.empty((B, H, S, hd), dtype=torch.float32, device=r.device)
             for _ in range(4)]
    du = torch.zeros_like(uf)
    for i in range(len(bounds) - 1, -1, -1):
        t0, t1 = bounds[i]
        *g, du_i, dS = _chunk_grads(rf[:, :, t0:t1], kf[:, :, t0:t1], vf[:, :, t0:t1],
                                    wf[:, :, t0:t1], uf, states[i], dS, states[i + 1],
                                    dof[:, :, t0:t1])
        for out, gi in zip(grads, g):
            out[:, :, t0:t1] = gi
        du = du + du_i
    dr, dk, dv, dlogw = grads
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlogw, du, dS


def route(S: int) -> str:
    """The kernel route of a call with S tokens."""
    return "decode" if S == 1 else "chunked"


def _model_layout(B, H, S, hd, dtype, device):
    """An empty (B, H, S, hd) tensor laid out as (B, S, H, hd)."""
    return torch.empty((B, S, H, hd), dtype=dtype, device=device).transpose(1, 2)


def _forward(r, k, v, logw, u, chunk: int, s0, which: str):
    """The kernel of route ``which`` on checked tensors -> (o, S_final,
    scratch): on the chunked route the scratch holds every chunk's S_in
    (B, H, chunks, hd, hd), on the decode route it is None."""
    B, H, S, hd = r.shape
    entry, _, counter = ROUTES[which]
    u = u.float().contiguous()
    if s0 is not None:
        s0 = s0.float().contiguous()
    o = _model_layout(B, H, S, hd, torch.float32, r.device)
    s_out = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    chunks = -(-S // chunk)
    scratch = (torch.empty((B, H, chunks, hd, hd), dtype=torch.float32, device=r.device)
               if which == "chunked" else None)
    if B == 0 or H == 0 or hd == 0:
        return o, s_out, scratch
    if S == 0:   # no token: the state passes through
        return o, (s_out.zero_() if s0 is None else s_out.copy_(s0)), scratch
    ptrs = [r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), o.data_ptr(), s_out.data_ptr()]
    if which == "decode":
        args = ptrs + [s for t in (r, k, v, logw, o) for s in t.stride()[:2]] + [B, H, hd]
    else:
        dec = torch.empty((B, H, chunks, hd), dtype=torch.float32, device=r.device)
        args = (ptrs + [scratch.data_ptr(), dec.data_ptr()]
                + [s for t in (r, k, v, logw, o) for s in t.stride()[:3]] + [B, H, S, hd, chunk])
    fn = getattr(build.load("rwkv6_scan", _ENTRIES), entry)
    err = build.on_device(r.device, lambda stream: fn(_DTYPES[r.dtype], *args, stream))
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    setattr(rwkv6_scan, counter, getattr(rwkv6_scan, counter) + 1)
    rwkv6_scan.launches += 1
    return o, s_out, scratch


@kernel_scope("kernels.rwkv6_scan_bwd")
def _backward(r, k, v, logw, u, s_out, scratch, do, ds_final, chunk: int):
    """The backward kernel's three launches on the forward's tensors and
    its chunk states -> (dr, dk, dv in r's type, dlogw, du (H, hd), ds0);
    do or ds_final None where that output took no gradient."""
    B, H, S, hd = r.shape
    dev = r.device
    if do is None:
        do = torch.zeros((B, H, S, hd), dtype=torch.float32, device=dev)
    do = do.float()
    if do.stride(-1) != 1:
        do = do.contiguous()
    dr, dk, dv = (_model_layout(B, H, S, hd, r.dtype, dev) for _ in range(3))
    dlogw = _model_layout(B, H, S, hd, torch.float32, dev)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    chunks = scratch.shape[2]
    if B == 0 or H == 0 or hd == 0 or S == 0:
        du = torch.zeros((H, hd), dtype=torch.float32, device=dev)
        return dr, dk, dv, dlogw, du, (ds0.zero_() if ds_final is None else ds0.copy_(ds_final))
    u = u.float().contiguous()
    if ds_final is not None:
        ds_final = ds_final.float().contiguous()
    dscratch = torch.empty_like(scratch)
    ddec, du_part = torch.empty((2, B, H, chunks, hd), dtype=torch.float32, device=dev)
    args = ([r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
             do.data_ptr(), scratch.data_ptr(), s_out.data_ptr(),
             None if ds_final is None else ds_final.data_ptr(), dscratch.data_ptr(),
             ddec.data_ptr(), du_part.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             dlogw.data_ptr(), ds0.data_ptr()]
            + [s for t in (r, k, v, logw, do, dr, dk, dv, dlogw) for s in t.stride()[:3]]
            + [B, H, S, hd, chunk])
    fn = build.load("rwkv6_scan_bwd", _BWD_ENTRIES).rwkv6_scan_bwd
    err = build.on_device(dev, lambda stream: fn(_DTYPES[r.dtype], *args, stream))
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd failed: CUDA error {err}")
    rwkv6_scan.launches_bwd += 3
    # du: each (batch, chunk) block's partial, summed in a fixed order
    return dr, dk, dv, dlogw, du_part.sum((0, 2)), ds0


class Rwkv6ScanFn(torch.autograd.Function):
    """The chunked scan with its hand-written backward: the inputs, S_final
    and the forward's chunk states (its scratch) are saved, so the backward
    does not run the forward's state passes again."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, chunk):
        o, s_out, scratch = _forward(r, k, v, logw, u, chunk, s0, "chunked")
        ctx.save_for_backward(r, k, v, logw, u, s_out, scratch)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return o, s_out

    @staticmethod
    def backward(ctx, do, ds_final):
        r, k, v, logw, u, s_out, scratch = ctx.saved_tensors
        dr, dk, dv, dlogw, du, ds0 = _backward(r, k, v, logw, u, s_out, scratch, do, ds_final,
                                               ctx.chunk)
        return dr, dk, dv, dlogw, du.to(u.dtype), ds0 if ctx.needs_input_grad[5] else None, None


def _launch(r, k, v, logw, u, chunk: int, s0):
    """The kernels on checked tensors -> (o, S_final): through
    ``Rwkv6ScanFn`` (the chunked route) where a gradient is wanted, else the
    route of S."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (r, k, v, logw, u, s0)):
        return Rwkv6ScanFn.apply(r, k, v, logw, u, s0, chunk)
    return _forward(r, k, v, logw, u, chunk, s0, route(r.shape[2]))[:2]


@kernel_scope("kernels.rwkv6_scan")
def rwkv6_scan(r, k, v, logw, u, *, chunk: int = DEFAULT_CHUNK,
               s0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, H, S, hd) f32/bf16; logw: (B, H, S, hd) f32; u: (H, hd);
    s0: (B, H, hd, hd) f32 or None -> (o (B, H, S, hd) f32, S_final)."""
    B, H, S, hd = _check(r, k, v, logw, u, s0)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, logw, u, chunk=chunk, s0=s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cuda or cpu, not {r.device}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share float32 or bfloat16, got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32:
        raise TypeError(f"logw must be float32, got {logw.dtype}")
    if any(t.device != r.device for t in (k, v, logw, u)) or (
            s0 is not None and s0.device != r.device):
        raise ValueError("all inputs must be on one device")
    if any(t.stride(-1) != 1 for t in (r, k, v, logw)):
        raise ValueError("r, k, v and logw need a contiguous head_dim")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim <= {MAX_HEAD_DIM}, got {hd}")
    chunk = min(chunk, max(S, 1))
    if chunk > MAX_CHUNK:
        raise ValueError(f"the kernel takes chunk <= {MAX_CHUNK}, got {chunk}")
    return _launch(r, k, v, logw, u, chunk, s0)


# kernel launches, for chip_smoke's path check: the forward's calls by route
# and their sum; the backward's launches (three a call)
rwkv6_scan.launches = rwkv6_scan.launches_chunked = rwkv6_scan.launches_decode = 0
rwkv6_scan.launches_bwd = 0

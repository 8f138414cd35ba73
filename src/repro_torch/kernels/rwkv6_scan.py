"""The chunked RWKV6 wkv recurrence — port of ``repro/kernels/rwkv6_scan.py``
and of the chunk loop in ``repro/models/rwkv6.py::rwkv_time_mix``.

    o_t = r_t · (S_{t-1} + (u ⊙ k_t) ⊗ v_t),   S_t = diag(e^{logw_t}) S_{t-1} + k_t ⊗ v_t

``rwkv6_scan`` launches the hand-written CUDA kernels (``csrc/rwkv6_scan.cu``)
for CUDA tensors and takes the plain PyTorch version beside it only for
CPU tensors; any other device raises. The kernels are forward only: on
the card a call under grad with an input that requires it raises. It
routes by S, explicitly:

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


def route(S: int) -> str:
    """The kernel route of a call with S tokens."""
    return "decode" if S == 1 else "chunked"


def _launch(r, k, v, logw, u, chunk: int, s0):
    """The kernel of S's route on checked tensors; returns (o, S_final).
    Forward only: raises where a gradient is wanted."""
    build.refuse_grad("rwkv6_scan", r, k, v, logw, u, s0)
    B, H, S, hd = r.shape
    which = route(S)
    entry, _, counter = ROUTES[which]
    u = u.float().contiguous()
    if s0 is not None:
        s0 = s0.float().contiguous()
    o = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device).transpose(1, 2)
    s_out = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B == 0 or H == 0 or hd == 0:
        return o, s_out
    if S == 0:   # no token: the state passes through
        return o, (s_out.zero_() if s0 is None else s_out.copy_(s0))
    ptrs = [r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), o.data_ptr(), s_out.data_ptr()]
    if which == "decode":
        args = ptrs + [s for t in (r, k, v, logw, o) for s in t.stride()[:2]] + [B, H, hd]
    else:
        chunks = -(-S // chunk)
        scratch = torch.empty((B, H, chunks, hd, hd), dtype=torch.float32, device=r.device)
        dec = torch.empty((B, H, chunks, hd), dtype=torch.float32, device=r.device)
        args = (ptrs + [scratch.data_ptr(), dec.data_ptr()]
                + [s for t in (r, k, v, logw, o) for s in t.stride()[:3]] + [B, H, S, hd, chunk])
    fn = getattr(build.load("rwkv6_scan", _ENTRIES), entry)
    err = build.on_device(r.device, lambda stream: fn(_DTYPES[r.dtype], *args, stream))
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    setattr(rwkv6_scan, counter, getattr(rwkv6_scan, counter) + 1)
    rwkv6_scan.launches += 1
    return o, s_out


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


# kernel launches, for chip_smoke's path check: by route, and their sum
rwkv6_scan.launches = rwkv6_scan.launches_chunked = rwkv6_scan.launches_decode = 0

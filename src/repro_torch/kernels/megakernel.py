"""K3 ``edge_interval``: one fused edge interval of flat-row linear clients
on a hand-written CUDA kernel (``csrc/megakernel.cu``), beside its plain
PyTorch version.

It replaces the Pallas TPU kernel ``edge_interval_pallas`` of
``repro/kernels/megakernel.py`` and computes the same function. Each client
row of ``params`` (N, P = feat * out) holds a linear map W (feat, out),
row-major, trained on a mean squared error. For every client of each of
``num_edges`` equal contiguous edges: kappa1 local SGD steps (with momentum
``momentum`` into ``mu`` when it is not 0) on ``inputs`` (N, kappa1, b,
feat) and ``targets`` (N, kappa1, b, out), then the edge's weighted mean
``sum_c w_c W_c / sum_c w_c``, broadcast back to its rows. Params and mu
(f32 or bf16) are widened to f32 once, stepped in f32 and written back once
in their dtype; inputs are read as f32; the sum of weights has no zero
guard (an all-zero-weight edge gives non-finite rows), as in JAX. Returns
``(params (N, P), losses (N, kappa1) f32, mu (N, P))``; with momentum 0 the
kernel neither reads nor writes mu, and ``mu`` comes back as given (zeros
when it was None).

The engine's ``engine="megakernel"`` path does not call K3 (as in JAX,
where only ``ops.edge_interval`` reaches it): it is a kernel entry point.
The JAX wrapper also refuses an edge block over the TPU's 12 MiB VMEM
budget; this kernel keeps one column per lane and has no such limit. It
refuses only what its own launch cannot take: a local batch so large that
one step of x and y per warp overflows a block's shared memory (longer
intervals run through a ring of up to 8 steps).

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel on the current stream (no
synchronisation) or raises. Each call is one launch: the last block of each
edge sums the step losses across column tiles, found through a per-edge
ticket in a small counter buffer kept per device and stream, which the
kernel leaves zeroed. ``LAUNCHES`` counts wrapper calls that launched it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

LAUNCHES: Dict[str, int] = {"edge_interval": 0}
# (device index, stream handle) -> int32 per-edge tickets, all zero between calls
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 32  # output columns per block (csrc/megakernel.cu kTile)
_REG_FEAT = 64  # feat up to this keeps a column in registers (kRegFeat)
MAX_SHARED_BYTES = 232448  # dynamic shared memory one Hopper block can use


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_shapes(params, inputs, targets, num_edges: int, feat: int, momentum: float, mu) -> Tuple[int, int]:
    """The JAX wrapper's checks with its messages (``megakernel.py:120-130``),
    plus the feat / out widths of the batch. Returns (N, out)."""
    n, p = params.shape
    if n % num_edges:
        raise ValueError(f"N={n} % num_edges={num_edges} != 0")
    if p % feat:
        raise ValueError(f"P={p} not divisible by feat={feat}")
    out = p // feat
    if (inputs.dim() != 4 or targets.dim() != 4 or inputs.shape[0] != n or targets.shape[0] != n
            or inputs.shape[1] != targets.shape[1] or inputs.shape[2] != targets.shape[2]
            or inputs.shape[3] != feat or targets.shape[3] != out):
        raise ValueError(
            f"batch shapes {tuple(inputs.shape)}/{tuple(targets.shape)} incompatible with params {tuple(params.shape)}"
        )
    if momentum != 0.0 and mu is None:
        raise ValueError("momentum != 0 needs a mu buffer")
    return n, out


# -- plain version -------------------------------------------------------------


def _interval_steps(params, xin, yin, mu, *, lr: float, momentum: float):
    """kappa1 SGD(+momentum) steps of one edge's clients, f32 einsums, as
    ``repro/kernels/megakernel.py:42-69``: params / mu (C, feat, out), xin
    (C, kappa1, b, feat), yin (C, kappa1, b, out). Returns (params, mu,
    losses (C, kappa1))."""
    k1 = xin.shape[1]
    b, out = yin.shape[2], yin.shape[3]
    losses = []
    for t in range(k1):
        x = xin[:, t]
        r = torch.einsum("cbf,cfo->cbo", x, params) - yin[:, t]
        losses.append(torch.mean(torch.square(r), dim=(1, 2)))
        g = (2.0 / (b * out)) * torch.einsum("cbf,cbo->cfo", x, r)
        if momentum != 0.0:
            mu = g + momentum * mu
            params = params - lr * mu
        else:
            params = params - lr * g
    return params, mu, torch.stack(losses, dim=1)


def edge_interval_plain(params: torch.Tensor, inputs: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor, *,
                        num_edges: int, feat: int, lr: float, momentum: float = 0.0,
                        mu: Optional[torch.Tensor] = None):
    """K3's function in plain PyTorch, edge by edge: the steps of
    ``_interval_steps`` then the weighted edge mean with no zero guard, as
    ``repro.kernels.ref.edge_interval_ref``."""
    n, out = _check_shapes(params, inputs, targets, num_edges, feat, momentum, mu)
    p = params.shape[1]
    c = n // num_edges
    if mu is None:
        mu = torch.zeros_like(params)
    f32 = torch.float32
    w = weights.reshape(n, 1).to(f32)
    outs, losses, mus = [], [], []
    for e in range(num_edges):
        sl = slice(e * c, (e + 1) * c)
        pe, me, le = _interval_steps(
            params[sl].to(f32).reshape(c, feat, out), inputs[sl].to(f32), targets[sl].to(f32),
            mu[sl].to(f32).reshape(c, feat, out), lr=lr, momentum=momentum,
        )
        we = w[sl]
        mean = torch.sum(pe * we[..., None], dim=0) / torch.sum(we)
        outs.append(mean.expand(c, feat, out).reshape(c, p))
        losses.append(le)
        mus.append(me.reshape(c, p))
    return torch.cat(outs).to(params.dtype), torch.cat(losses), torch.cat(mus).to(params.dtype)


# -- kernel wrapper -------------------------------------------------------------


def scratch(n: int, feat: int, out: int, k1: int, momentum: bool, device) -> Tuple[Optional[torch.Tensor], ...]:
    """The kernel's device-memory scratch: (work, work_mu, partial). Above
    feat 64 a client's working column lives in ``work`` (and its momentum in
    ``work_mu``), f32 (N, feat, out padded to whole 32-column tiles); with
    feat <= 64 the columns stay in registers and both are None. ``partial``
    (N, kappa1, tiles) holds each step's loss per column tile."""
    f32 = torch.float32
    ntiles = -(-out // _TILE)
    work = work_mu = None
    if feat > _REG_FEAT:
        work = torch.empty((n, feat, ntiles * _TILE), dtype=f32, device=device)
        if momentum:
            work_mu = torch.empty_like(work)
    return work, work_mu, torch.empty((n, k1, ntiles), dtype=f32, device=device)


def ticket_buffer(cache: Dict, key, num_edges: int, device) -> torch.Tensor:
    """The int32 per-edge tickets for ``key`` (a device and stream), at least
    ``num_edges`` of them, zero: made on first use and grown when a call has
    more edges. The kernel takes a ticket per block and the last block of
    each edge zeroes its counter, so the buffer is zero again after every
    launch; calls on one stream run in order, so they share it safely."""
    buf = cache.get(key)
    if buf is None or buf.numel() < num_edges:
        buf = torch.zeros(max(num_edges, 2 * (0 if buf is None else buf.numel())), dtype=torch.int32,
                          device=device)
        cache[key] = buf
    return buf


def column_loads(params: torch.Tensor, inputs: torch.Tensor, *, num_edges: int, feat: int, momentum: float = 0.0,
                 mu: Optional[torch.Tensor] = None) -> str:
    """How a call with these CUDA tensors brings each client's columns of W
    and mu in: ``"tma"`` (one box per client and array into shared memory:
    16-byte rows and bases, feat <= 64) or ``"lanes"`` (one load per lane
    and row)."""
    n, k1, b = inputs.shape[0], inputs.shape[1], inputs.shape[2]
    lib = _build.load("megakernel")
    tma = lib.mk_edge_interval_uses_tma(params.data_ptr(), 0 if mu is None else mu.data_ptr(), n, num_edges, feat,
                                        params.shape[1] // feat, k1, b, float(np.float32(momentum)),
                                        _DTYPE_CODES[params.dtype])
    return "tma" if tma else "lanes"


def edge_interval(params: torch.Tensor, inputs: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor, *,
                  num_edges: int, feat: int, lr: float, momentum: float = 0.0, mu: Optional[torch.Tensor] = None):
    """K3: kappa1 local SGD(+momentum) steps of every client's linear MSE
    model plus the trailing per-edge weighted mean. Returns (params (N, P),
    losses (N, kappa1) f32, mu (N, P))."""
    if params.device.type == "cpu":
        return edge_interval_plain(params, inputs, targets, weights, num_edges=num_edges, feat=feat, lr=lr,
                                   momentum=momentum, mu=mu)
    if params.device.type != "cuda":
        raise ValueError(f"edge_interval: tensors must be on the CPU (plain version) or CUDA, got {params.device}")
    n, out = _check_shapes(params, inputs, targets, num_edges, feat, momentum, mu)
    dev = params.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"edge_interval: params are on {dev} but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    if params.dtype not in _DTYPE_CODES:
        raise ValueError(f"edge_interval: params dtype must be float32 or bfloat16, got {params.dtype}")
    for name, t in (("inputs", inputs), ("targets", targets), ("weights", weights), ("mu", mu)):
        if t is not None and t.device != dev:
            raise ValueError(f"edge_interval: {name} on {t.device} but params on {dev}")
    if tuple(weights.shape) != (n,):
        raise ValueError(f"edge_interval: weights must have shape ({n},), got {tuple(weights.shape)}")
    if mu is not None and (mu.dtype != params.dtype or mu.shape != params.shape or not mu.is_contiguous()):
        raise ValueError("edge_interval: mu must be a contiguous tensor of the params' shape and dtype")
    if not params.is_contiguous():
        raise ValueError("edge_interval: params must be contiguous")
    if params.numel() >= 2**31:
        raise ValueError(f"edge_interval: params have {params.numel()} elements; the kernel indexes the C entry "
                         "point's sizes with int32")
    lib = _build.load("megakernel")
    k1, b = inputs.shape[1], inputs.shape[2]
    smem = lib.mk_edge_interval_smem(n, num_edges, k1, b, feat)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"edge_interval: a local batch of b={b} at feat={feat} needs {smem} bytes of shared "
                         f"memory per block (one step of x and y per warp), over the {MAX_SHARED_BYTES} a block "
                         "can use")
    f32 = torch.float32
    x = inputs.to(f32).contiguous()  # read as f32, as the JAX kernel does
    y = targets.to(f32).contiguous()
    w = weights.to(f32).contiguous()
    momentum_f = float(np.float32(momentum))
    new_params = torch.empty_like(params)
    losses = torch.empty((n, k1), dtype=f32, device=dev)
    work, work_mu, partial = scratch(n, feat, out, k1, momentum_f != 0.0, dev)
    stream = torch.cuda.current_stream()
    tickets = ticket_buffer(_TICKETS, (dev.index, stream.cuda_stream), num_edges, dev)
    if momentum_f != 0.0:
        new_mu = torch.empty_like(params)
    else:
        new_mu = mu if mu is not None else torch.zeros_like(params)
    err = lib.mk_edge_interval(
        params.data_ptr(), x.data_ptr(), y.data_ptr(), w.data_ptr(), 0 if mu is None else mu.data_ptr(),
        new_params.data_ptr(), new_mu.data_ptr(), losses.data_ptr(), 0 if work is None else work.data_ptr(),
        0 if work_mu is None else work_mu.data_ptr(), partial.data_ptr(), tickets.data_ptr(), n, num_edges, feat,
        out, k1, b, float(np.float32(lr)), momentum_f, float(np.float32(2.0 / (b * out))),
        _DTYPE_CODES[params.dtype], stream.cuda_stream,
    )
    _build.raise_on_error(err, "edge_interval")
    LAUNCHES["edge_interval"] += 1
    return new_params, losses, new_mu

"""EvolveGCN-O's weight evolution on the GPU: binding and autograd wrapper
for csrc/egcn_evolve.cu.

    qs = evolve(params, steps)    # [steps, d, c]: Q_1 .. Q_steps

from a GRCU layer's parameters {q0 [d, c]; w_u, u_u, w_r, u_r, w_h, u_h
[d, d]; b_u, b_r, b_h [d, c]} (models/egcn.py::GRCU): the matrix GRU of
Pareja et al. (arXiv:1902.10191, the code's mat_GRU_cell) run `steps`
times from Q_0, one snapshot a step:

    U  = sigmoid(W_u Q + U_u Q + B_u)
    R  = sigmoid(W_r Q + U_r Q + B_r)
    H~ = tanh((W_h Q + B_h) + U_h (R o Q))
    Q' = (1 - U) o Q + U o H~

It replaces no Pallas kernel: the JAX package has no temporal model. The
plain version, the formulation that the model's CPU path takes and the
kernels are held against, is `evolve_plain` (ATen ops, differentiated by
autograd).

On the card each pass of the chain is one persistent launch where the
shape allows (`persistent(d, c)`: d <= CHAIN_MAX_D = 256, a thread block
cluster of ceil(d / 16) CTAs for each strip of 40 columns, the weights' rows
held in shared memory through all the steps; the source's note): the
forward (egcn_chain_fwd; with a gradient to come it also keeps every
step's U, R and H~), and the backward through time (egcn_chain_bwd: every
step's pre-activation cotangents dA_h, dA_u, dA_r and Q_0's cotangent).
Past the limit the chain runs one step at a time, two launches a step
forward (egcn_gates, egcn_update) and two backward from the last
(egcn_bwd_gate: the gates' pre-activation cotangents and the direct part of
dQ; egcn_bwd_dq: the rest of dQ, plus the cotangent Q_{t-1} takes from its
own use). The choice is by shape alone. Either way the weights' gradients
follow over all steps at once (egcn_wgrad) and the biases' (egcn_bias_sum).
W_u and U_u see the same input Q, so their gradients are equal (and W_r's
and U_r's): the kernel writes each pair from one sum. No float atomics: two
launches on the same inputs give the same bits, and the forward without a
gradient to come gives the kept forward's.

Each step function takes its plain twin (`*_plain`, the same arithmetic in
ATen ops) for CPU tensors, so that the CPU tests drive the same forward and
backward through time as the card; for CUDA tensors it launches or raises.
The source is compiled with nvcc for sm_90a at first use
(kernels/cuda_build.py) and loaded with ctypes. Operands: contiguous f32 on
one device; on the card the output width c a multiple of 4.

`launches` counts launches by kernel: egcn_chain_fwd, egcn_chain_bwd,
egcn_gates, egcn_update, egcn_bwd_gate, egcn_bwd_dq, egcn_wgrad,
egcn_bias_sum.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import cuda_build

PARAMS = ("q0", "w_u", "u_u", "b_u", "w_r", "u_r", "b_r", "w_h", "u_h", "b_h")
# the persistent chain's largest d: a cluster of at most 16 CTAs of 16 rows
CHAIN_MAX_D = 256
launches = {"egcn_chain_fwd": 0, "egcn_chain_bwd": 0, "egcn_gates": 0, "egcn_update": 0,
            "egcn_bwd_gate": 0, "egcn_bwd_dq": 0, "egcn_wgrad": 0, "egcn_bias_sum": 0}
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        # an EvolveGCN-O step on BSDA tables needs bsda_spmm too: one parallel nvcc batch
        lib = ctypes.CDLL(cuda_build.build(("bsda_spmm", "egcn_evolve"))["egcn_evolve"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.egcn_gates_launch.argtypes = [p] * 12 + [i, i, p]
        lib.egcn_update_launch.argtypes = [p] * 7 + [i, i, p]
        lib.egcn_bwd_gate_launch.argtypes = [p] * 10 + [i, i, p]
        lib.egcn_bwd_dq_launch.argtypes = [p] * 11 + [i, i, p]
        lib.egcn_wgrad_launch.argtypes = [p] * 5 + [i, i, i] + [p] * 7
        lib.egcn_bias_sum_launch.argtypes = [p] * 3 + [i, i, i] + [p] * 4
        lib.egcn_chain_fwd_launch.argtypes = [p] * 15 + [i, i, i, p]
        lib.egcn_chain_bwd_launch.argtypes = [p] * 16 + [i, i, i, p]
        for fn in (lib.egcn_gates_launch, lib.egcn_update_launch, lib.egcn_bwd_gate_launch,
                   lib.egcn_bwd_dq_launch, lib.egcn_wgrad_launch, lib.egcn_bias_sum_launch,
                   lib.egcn_chain_fwd_launch, lib.egcn_chain_bwd_launch):
            fn.restype = i
        lib.egcn_chain_stage_floats.argtypes = [i, i]
        lib.egcn_chain_stage_floats.restype = ctypes.c_longlong
        lib.egcn_error_string.argtypes = [i]
        lib.egcn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(key: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"egcn_evolve {key} launch failed: "
                           f"{_load().egcn_error_string(rc).decode()}")
    launches[key] += 1


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(*tensors: Optional[torch.Tensor]) -> None:
    """Raises unless every operand is a contiguous f32 tensor on the first
    one's device."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"egcn_evolve takes contiguous float32 operands on one device; "
                             f"got {t.dtype}, contiguous={t.is_contiguous()}, on {t.device}")


def gates_plain(p: Dict[str, torch.Tensor], q: torch.Tensor):
    """(U, R, P = W_h Q + B_h) of one step."""
    u = torch.sigmoid(p["w_u"] @ q + p["u_u"] @ q + p["b_u"])
    r = torch.sigmoid(p["w_r"] @ q + p["u_r"] @ q + p["b_r"])
    return u, r, p["w_h"] @ q + p["b_h"]


def update_plain(uh, q, r, u, ph):
    """(H~, Q') of one step."""
    h = torch.tanh(ph + uh @ (r * q))
    return h, (1.0 - u) * q + u * h


def gates(p: Dict[str, torch.Tensor], q: torch.Tensor, u: torch.Tensor, r: torch.Tensor,
          ph: torch.Tensor) -> None:
    """U, R and P of one step from Q, written into u, r, ph [d, c]."""
    if not q.is_cuda:
        for dst, src in zip((u, r, ph), gates_plain(p, q)):
            dst.copy_(src)
        return
    d, c = q.shape
    _launch("egcn_gates", _load().egcn_gates_launch(
        *(p[k].data_ptr() for k in ("w_u", "u_u", "w_r", "u_r", "w_h", "b_u", "b_r", "b_h")),
        q.data_ptr(), u.data_ptr(), r.data_ptr(), ph.data_ptr(), d, c, _stream(q)))


def update(uh, q, r, u, ph, h, qn) -> None:
    """H~ and Q' of one step, written into h, qn [d, c]."""
    if not q.is_cuda:
        hp, qp = update_plain(uh, q, r, u, ph)
        h.copy_(hp)
        qn.copy_(qp)
        return
    d, c = q.shape
    _launch("egcn_update", _load().egcn_update_launch(
        uh.data_ptr(), q.data_ptr(), r.data_ptr(), u.data_ptr(), ph.data_ptr(), h.data_ptr(),
        qn.data_ptr(), d, c, _stream(q)))


def bwd_gate_plain(uh, dqn, u, h, q, r):
    """(dA_h, dA_u, dA_r, the direct part of dQ) of one step from dQ'."""
    dah = dqn * u * (1.0 - h * h)
    grq = uh.t() @ dah
    return (dah, dqn * (h - q) * u * (1.0 - u), grq * q * r * (1.0 - r),
            dqn * (1.0 - u) + grq * r)


def bwd_gate(uh, dqn, u, h, q, r, dah, dau, dar, dqp) -> None:
    if not q.is_cuda:
        for dst, src in zip((dah, dau, dar, dqp), bwd_gate_plain(uh, dqn, u, h, q, r)):
            dst.copy_(src)
        return
    d, c = q.shape
    _launch("egcn_bwd_gate", _load().egcn_bwd_gate_launch(
        *(t.data_ptr() for t in (uh, dqn, u, h, q, r, dah, dau, dar, dqp)), d, c, _stream(q)))


def bwd_dq_plain(p, dah, dau, dar, dqp, extra=None):
    dq = (dqp + p["w_h"].t() @ dah + p["w_u"].t() @ dau + p["u_u"].t() @ dau
          + p["w_r"].t() @ dar + p["u_r"].t() @ dar)
    return dq if extra is None else dq + extra


def bwd_dq(p, dah, dau, dar, dqp, extra, dq) -> None:
    """dQ_{t-1} into dq: the direct part dqp, the products through the
    gates' weights and `extra` (None, or the cotangent of Q_{t-1}'s use)."""
    if not dq.is_cuda:
        dq.copy_(bwd_dq_plain(p, dah, dau, dar, dqp, extra))
        return
    d, c = dq.shape
    _launch("egcn_bwd_dq", _load().egcn_bwd_dq_launch(
        *(p[k].data_ptr() for k in ("w_h", "w_u", "u_u", "w_r", "u_r")),
        dah.data_ptr(), dau.data_ptr(), dar.data_ptr(), dqp.data_ptr(), _ptr(extra),
        dq.data_ptr(), d, c, _stream(dq)))


def wgrad_plain(dah, dau, dar, qin, r):
    """{name: gradient} of the six [d, d] weights over all steps."""
    def over(da, x):
        return torch.einsum("tij,tkj->ik", da, x)

    gu, gr = over(dau, qin), over(dar, qin)
    return {"w_h": over(dah, qin), "u_h": over(dah, r * qin), "w_u": gu, "u_u": gu.clone(),
            "w_r": gr, "u_r": gr.clone()}


def wgrad(dah, dau, dar, qin, r) -> Dict[str, torch.Tensor]:
    if not qin.is_cuda:
        return wgrad_plain(dah, dau, dar, qin, r)
    steps, d, c = qin.shape
    out = {k: qin.new_empty((d, d)) for k in ("w_h", "u_h", "w_u", "u_u", "w_r", "u_r")}
    _launch("egcn_wgrad", _load().egcn_wgrad_launch(
        dah.data_ptr(), dau.data_ptr(), dar.data_ptr(), qin.data_ptr(), r.data_ptr(), steps, d,
        c, *(out[k].data_ptr() for k in ("w_h", "u_h", "w_u", "u_u", "w_r", "u_r")),
        _stream(qin)))
    return out


def bias_sum(dah, dau, dar) -> Dict[str, torch.Tensor]:
    if not dah.is_cuda:
        return {"b_h": dah.sum(0), "b_u": dau.sum(0), "b_r": dar.sum(0)}
    steps, d, c = dah.shape
    out = {k: dah.new_empty((d, c)) for k in ("b_h", "b_u", "b_r")}
    _launch("egcn_bias_sum", _load().egcn_bias_sum_launch(
        dah.data_ptr(), dau.data_ptr(), dar.data_ptr(), steps, d, c,
        out["b_h"].data_ptr(), out["b_u"].data_ptr(), out["b_r"].data_ptr(), _stream(dah)))
    return out


def persistent(d: int, c: int) -> bool:
    """Whether the card runs the chain of a [d, c] Q as one persistent
    launch a pass (egcn_chain_fwd, egcn_chain_bwd), or else a step at a
    time: d at most CHAIN_MAX_D (c a multiple of 4, as every kernel here
    takes)."""
    return 1 <= d <= CHAIN_MAX_D and c >= 1 and c % 4 == 0


def _stage(like: torch.Tensor, matrices: int) -> torch.Tensor:
    """Scratch through which a pass's CTAs hand each other their rows of
    `matrices` exchanged [d, c] matrices (the kernel's layout)."""
    d, c = like.shape[-2:]
    return like.new_empty(matrices * _load().egcn_chain_stage_floats(d, c))


def forward_chain(p: Dict[str, torch.Tensor], steps: int, keep: bool):
    """The chain's forward in one launch (egcn_chain_fwd): as `_run`. CUDA
    tensors of a shape `persistent` takes."""
    q0 = p["q0"]
    d, c = q0.shape
    qs = q0.new_empty((steps + 1, d, c))
    kept = tuple(q0.new_empty((steps, d, c)) for _ in range(3)) if keep else (None,) * 3
    _launch("egcn_chain_fwd", _load().egcn_chain_fwd_launch(
        *(p[k].data_ptr() for k in ("w_u", "u_u", "w_r", "u_r", "w_h", "u_h", "b_u", "b_r",
                                    "b_h", "q0")),
        qs.data_ptr(), *(_ptr(t) for t in kept), _stage(q0, 2).data_ptr(), steps, d, c,
        _stream(q0)))
    return qs, (kept if keep else None)


def forward_steps(p: Dict[str, torch.Tensor], steps: int, keep: bool):
    """The chain's forward a step at a time (the step functions): as
    `_run`."""
    q0 = p["q0"]
    d, c = q0.shape
    qs = q0.new_empty((steps + 1, d, c))
    qs[0].copy_(q0)
    # with `keep` a slot a step; else one scratch [d, c] each, every step
    us, rs, hs = (q0.new_empty((steps if keep else 1, d, c)).expand(steps, d, c)
                  for _ in range(3))
    ph = q0.new_empty((d, c))
    for t in range(steps):
        u, r, h = us[t], rs[t], hs[t]
        gates(p, qs[t], u, r, ph)
        update(p["u_h"], qs[t], r, u, ph, h, qs[t + 1])
    return qs, ((us, rs, hs) if keep else None)


def _run(p: Dict[str, torch.Tensor], steps: int, keep: bool):
    """The chain's forward: (qs [steps + 1, d, c] = Q_0 .. Q_steps, and with
    `keep` the stacks U, R, H~ [steps, d, c], else None)."""
    q0 = p["q0"]
    if q0.is_cuda and persistent(*q0.shape):
        return forward_chain(p, steps, keep)
    return forward_steps(p, steps, keep)


def backward_chain(p, g, qs, us, rs, hs):
    """The backward through time in one launch (egcn_chain_bwd): as
    `_backward`. CUDA tensors of a shape `persistent` takes."""
    steps, d, c = us.shape
    dah, dau, dar = (g.new_empty((steps, d, c)) for _ in range(3))
    dq = g.new_empty((d, c))
    _launch("egcn_chain_bwd", _load().egcn_chain_bwd_launch(
        *(p[k].data_ptr() for k in ("u_h", "w_h", "w_u", "u_u", "w_r", "u_r")),
        *(t.data_ptr() for t in (g, qs, us, rs, hs, dah, dau, dar, dq)),
        _stage(g, 3).data_ptr(), steps, d, c, _stream(g)))
    return dq, dah, dau, dar


def backward_steps(p, g, qs, us, rs, hs):
    """The backward through time a step at a time (the step functions): as
    `_backward`."""
    steps, d, c = us.shape
    dah, dau, dar = (g.new_empty((steps, d, c)) for _ in range(3))
    dqp = g.new_empty((d, c))
    dq = g.new_empty((d, c))
    dqn = g[steps - 1]
    for t in range(steps - 1, -1, -1):
        bwd_gate(p["u_h"], dqn, us[t], hs[t], qs[t], rs[t], dah[t], dau[t], dar[t], dqp)
        bwd_dq(p, dah[t], dau[t], dar[t], dqp, g[t - 1] if t > 0 else None, dq)
        dqn = dq
    return dq, dah, dau, dar


def _backward(p, g, qs, us, rs, hs):
    """From the cotangents g [steps, d, c] of Q_1 .. Q_steps and the kept
    forward: (Q_0's cotangent [d, c], every step's dA_h, dA_u, dA_r [steps,
    d, c])."""
    if g.is_cuda and persistent(*g.shape[1:]):
        return backward_chain(p, g, qs, us, rs, hs)
    return backward_steps(p, g, qs, us, rs, hs)


class _Evolve(torch.autograd.Function):
    """The chain with its hand-written backward through time (module
    docstring). Inputs: the layer's parameters in PARAMS order."""

    @staticmethod
    def forward(ctx, steps, *tensors):
        p = dict(zip(PARAMS, tensors))
        qs, (us, rs, hs) = _run(p, steps, keep=True)
        ctx.save_for_backward(qs, us, rs, hs, *tensors)
        return qs[1:]

    @staticmethod
    def backward(ctx, grad):
        qs, us, rs, hs, *tensors = ctx.saved_tensors
        p = dict(zip(PARAMS, tensors))
        steps = us.shape[0]
        dq, dah, dau, dar = _backward(p, grad.contiguous(), qs, us, rs, hs)
        grads = {"q0": dq, **wgrad(dah, dau, dar, qs[:steps], rs), **bias_sum(dah, dau, dar)}
        return (None, *(grads[k] if ctx.needs_input_grad[1 + i] else None
                        for i, k in enumerate(PARAMS)))


def evolve(p: Dict[str, torch.Tensor], steps: int) -> torch.Tensor:
    """Q_1 .. Q_steps [steps, d, c] from the layer's parameters `p` (PARAMS),
    differentiable where a gradient is to come: the kernels for CUDA
    tensors, the step functions' plain twins for CPU tensors."""
    tensors = [p[k] for k in PARAMS]
    _check(*tensors)
    if tensors[0].is_cuda and tensors[0].shape[1] % 4 != 0:
        raise ValueError(f"the egcn_evolve kernels take widths c that are multiples of 4 "
                         f"(they read four columns at once); got {tensors[0].shape[1]}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Evolve.apply(int(steps), *tensors)
    with torch.no_grad():
        return _run(p, int(steps), keep=False)[0][1:]


def evolve_plain(p: Dict[str, torch.Tensor], steps: int) -> torch.Tensor:
    """The chain in ATen ops, differentiated by autograd: the yardstick of
    `evolve` and the path of the model's CPU forward."""
    q, out = p["q0"], []
    for _ in range(int(steps)):
        u, r, ph = gates_plain(p, q)
        _, q = update_plain(p["u_h"], q, r, u, ph)
        out.append(q)
    return torch.stack(out)

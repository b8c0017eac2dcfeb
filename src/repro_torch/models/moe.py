"""Mixture-of-Experts: top-k routing, the dense oracle and expert
parallelism over the ``model`` axis of a mesh.

Port of :mod:`repro.models.moe`.  Two execution paths, as in the reference:

* :func:`moe_dense` — every token through every expert, gate-weighted
  (O(E) flops; the correctness oracle and the path without a mesh).

* :func:`moe_ep` — per bank of the mesh's ``model`` axis: top-k routing ->
  capacity-bucketed dispatch by :meth:`all_to_all` over the banks -> a
  grouped GEMM over the bank's local experts (tokens sorted by local expert
  id, one product per non-empty group) -> :meth:`all_to_all` back ->
  gate-weighted combine.  Over-capacity assignments are dropped exactly as
  the reference drops them: the capacity, the stable sort by destination
  and the rank within the bucket are the reference's, and so are the
  tokens each bank owns (its slice of the sequence when the sequence
  divides over the banks and is longer than 1, else all of its batch rows).
  On a :class:`~repro_torch.dist.LocalMesh` the banks are slices of one
  device and run one after the other; on a
  :class:`~repro_torch.dist.ProcessGroupMesh` each rank is one bank and
  the output is gathered onto every rank.

Shared experts (DeepSeek) run as a dense MLP beside either path.
"""

from __future__ import annotations

import contextvars

import torch
from torch import nn

from repro_torch.configs.base import ModelCfg
from repro_torch.dist.mesh import LocalMesh
from repro_torch.models import layers

EP_AXIS = "model"
DP_AXES = ("pod", "data")

#: While set, :func:`moe_block` hands each layer that would take the EP
#: path to this callable, ``(params, x, cfg, mesh) -> (out, aux)``: a cost
#: counter on the meta device, where EP cannot run (it reads the group
#: sizes to the host; :func:`repro_torch.launch.dryrun.moe_static`).  The
#: dense path runs there as it is.
MOE_COUNTER: contextvars.ContextVar = contextvars.ContextVar(
    "moe_counter", default=None)


class MoE(nn.Module):
    """``router`` (d, E) float32, ``w1`` (E, d, 2F) the fused gate+up,
    ``w2`` (E, F, d) and, with shared experts, ``shared`` (an
    :class:`~repro_torch.models.layers.MLP` of width ``n_shared * F``);
    allocated uninitialised, :func:`init` draws them."""

    def __init__(self, cfg: ModelCfg, dtype=torch.bfloat16, device=None):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
        kw = {"dtype": dtype, "device": device}
        self.router = layers.frozen(torch.empty(
            (d, e), dtype=torch.float32, device=device))
        self.w1 = layers.frozen(torch.empty((e, d, 2 * f), **kw))
        self.w2 = layers.frozen(torch.empty((e, f, d), **kw))
        if m.n_shared:
            self.shared = layers.MLP(d, m.n_shared * f, dtype, device)


def init(generator, cfg: ModelCfg, dtype=torch.bfloat16, device=None) -> MoE:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    p = MoE(cfg, dtype, device)
    p.router.copy_(layers.dense_init(generator, d, e, torch.float32, device))
    for w, fan_in in ((p.w1, d), (p.w2, f)):
        draw = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                           device=device)
        w.copy_(draw.mul_((1 / fan_in) ** 0.5))
    if m.n_shared:
        p.shared = layers.mlp_init(generator, d, m.n_shared * f, dtype,
                                   device)
    return p


def specs(cfg: ModelCfg, rules, for_opt: bool = False) -> dict:
    """Expert-weight specs.

    By default the experts lie on ``tp`` and D on ``fsdp``.  With
    ``cfg.parallel.moe_zero1`` the weights lie on ``tp`` only, and the
    optimizer state (``for_opt=True``) keeps the ``fsdp`` split, so the
    state alone is sharded over ``data`` there.
    """
    if cfg.parallel.moe_zero1 and not for_opt:
        s = {"router": (None, None), "w1": (rules.tp, None, None),
             "w2": (rules.tp, None, None)}
    else:
        s = {"router": (None, None), "w1": (rules.tp, rules.fsdp, None),
             "w2": (rules.tp, None, rules.fsdp)}
    if cfg.moe.n_shared:
        s["shared"] = layers.mlp_specs(rules)
    return s


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, top_k: int):
    """(T, D) -> (gates (T,k) float32 normalised, experts (T,k) int64,
    probs (T,E) float32).

    The top k by a stable descending sort, so equal probabilities keep the
    lower expert first, as ``jax.lax.top_k`` orders them.
    """
    probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :top_k], experts[:, :top_k]
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    return gates, experts, probs


def load_balance_loss(probs: torch.Tensor, experts: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e."""
    f = nn.functional.one_hot(experts[..., 0], n_experts).float().mean(dim=0)
    return n_experts * torch.sum(f * probs.mean(dim=0))


# ---------------------------------------------------------------------------
# Dense oracle
# ---------------------------------------------------------------------------

def moe_dense(params: MoE, x: torch.Tensor, cfg: ModelCfg):
    """(B,S,D) -> ((B,S,D), aux): every expert computes every token."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gates, experts, probs = _route(params.router, xf, m.top_k)
    h = torch.einsum("td,edf->tef", xf, params.w1)
    gate_h, up_h = h.chunk(2, dim=-1)
    h = layers.silu(gate_h) * up_h
    y_all = torch.einsum("tef,efd->ted", h, params.w2)        # (T, E, D)
    sel = nn.functional.one_hot(experts, m.n_experts).to(y_all.dtype)
    w = torch.einsum("tke,tk->te", sel, gates.to(y_all.dtype))
    out = torch.einsum("ted,te->td", y_all, w).reshape(b, s, d)
    if m.n_shared:
        out = out + layers.mlp(params.shared, x)
    return out, load_balance_loss(probs, experts, m.n_experts)


# ---------------------------------------------------------------------------
# Expert-parallel path
# ---------------------------------------------------------------------------

def capacity(t_loc: int, cfg: ModelCfg, ep: int) -> int:
    """Slots per (source bank, destination bank) pair: the reference's
    ``max(8, ceil(T_loc * k * capacity_factor / ep))``."""
    m = cfg.moe
    return int(max(8, -(-t_loc * m.top_k * m.capacity_factor // ep)))


def _expert_ffn_local(w1, w2, tokens, group_sizes: list[int]):
    """Grouped GEMM over a bank's local experts: ``tokens`` (N, D) sorted
    by local expert id, ``group_sizes`` the rows of each expert (their sum
    at most N; rows past it are left zero).  One product per non-empty
    group, as ``jax.lax.ragged_dot`` computes the reference's."""
    out = tokens.new_zeros(tokens.shape)
    start = 0
    for e, n in enumerate(group_sizes):
        if n:
            h = tokens[start:start + n] @ w1[e]
            gate_h, up_h = h.chunk(2, dim=-1)
            out[start:start + n] = (layers.silu(gate_h) * up_h) @ w2[e]
        start += n
    return out


def dispatch_plan(experts: torch.Tensor, ep: int, e_local: int, cap: int):
    """Where each (token, choice) assignment of one bank goes.

    ``experts`` (T, k) -> (``order``: the assignments stably sorted by
    destination bank, ``dest``: that bank for each sorted assignment,
    ``slot``: its slot in the (ep, cap + 1) send buffer, the last slot of
    each destination the garbage slot, ``keep``: whether it was kept).  An
    assignment is kept iff its rank within its destination's bucket is
    below ``cap``.
    """
    n = experts.numel()
    flat_exp = experts.reshape(-1)
    dest = torch.div(flat_exp, e_local, rounding_mode="floor")
    order = torch.argsort(dest, stable=True)
    sdest = dest[order]
    starts = torch.searchsorted(
        sdest, torch.arange(ep, device=sdest.device, dtype=sdest.dtype),
        side="left")
    rank = torch.arange(n, device=sdest.device) - starts[sdest]
    keep = rank < cap
    return order, sdest, torch.clamp(rank, max=cap), keep


def _bank_body(x_loc, gates, experts, cfg: ModelCfg, ep: int, cap: int):
    """The send buffers of one bank: (x (ep, cap, D), local expert id,
    source token, gate, valid), each (ep, cap, ...)."""
    m = cfg.moe
    t_loc, d = x_loc.shape
    e_local = m.n_experts // ep
    dev = x_loc.device
    order, sdest, slot, keep = dispatch_plan(experts, ep, e_local, cap)
    src_tok = torch.arange(t_loc, device=dev).repeat_interleave(
        m.top_k)[order]
    flat_exp = experts.reshape(-1)[order]
    send_x = x_loc.new_zeros((ep, cap + 1, d))
    send_x[sdest, slot] = x_loc[src_tok]
    send = {"x": send_x}
    for name, val, dtype in (("eid", flat_exp % e_local, torch.int64),
                             ("src", src_tok, torch.int64),
                             ("gate", gates.reshape(-1)[order],
                              torch.float32),
                             ("valid", keep, torch.bool)):
        buf = torch.zeros((ep, cap + 1), dtype=dtype, device=dev)
        buf[sdest, slot] = val
        send[name] = buf
    return {k: v[:, :cap] for k, v in send.items()}


def _experts_of_bank(params: MoE, recv_x, recv_eid, recv_valid, bank: int,
                     e_local: int):
    """One bank's expert outputs for what it received: (ep, cap, D), zero
    on invalid slots."""
    ep, cap, d = recv_x.shape
    rx = recv_x.reshape(ep * cap, d)
    rvalid = recv_valid.reshape(-1)
    # invalid slots sort past the last expert and are not computed
    reid = torch.where(rvalid, recv_eid.reshape(-1), e_local)
    sort_idx = torch.argsort(reid, stable=True)
    sizes = torch.bincount(reid, minlength=e_local + 1)[:e_local].tolist()
    lo = bank * e_local
    y_sorted = _expert_ffn_local(params.w1[lo:lo + e_local],
                                 params.w2[lo:lo + e_local], rx[sort_idx],
                                 sizes)
    y = torch.zeros_like(rx).index_copy(0, sort_idx, y_sorted)
    return y.reshape(ep, cap, d)


def _ep_banks(params: MoE, x_loc, cfg: ModelCfg, mesh, banks: list[int]):
    """EP over the banks this process holds.  ``x_loc`` (nb, T_loc, D),
    one row per held bank -> ((nb, T_loc, D), (nb,) aux per bank)."""
    m = cfg.moe
    nb, t_loc, d = x_loc.shape
    ep = mesh.shape[EP_AXIS]
    e_local = m.n_experts // ep
    cap = capacity(t_loc, cfg, ep)
    gates, experts, probs = _route(params.router, x_loc.reshape(-1, d),
                                   m.top_k)
    gates = gates.reshape(nb, t_loc, -1)
    experts = experts.reshape(nb, t_loc, -1)
    probs = probs.reshape(nb, t_loc, -1)
    aux = torch.stack([load_balance_loss(probs[i], experts[i], m.n_experts)
                       for i in range(nb)])
    sends = [_bank_body(x_loc[i], gates[i], experts[i], cfg, ep, cap)
             for i in range(nb)]
    send = {k: torch.stack([s[k] for s in sends]) for k in sends[0]}
    # dispatch: (nb, ep_dst, cap, ...) -> (nb, ep_src, cap, ...)
    recv_x = mesh.all_to_all(send["x"], EP_AXIS)
    recv_eid = mesh.all_to_all(send["eid"], EP_AXIS)
    recv_valid = mesh.all_to_all(send["valid"], EP_AXIS)
    y = torch.stack([_experts_of_bank(params, recv_x[i], recv_eid[i],
                                      recv_valid[i], bank, e_local)
                     for i, bank in enumerate(banks)])
    back = mesh.all_to_all(y, EP_AXIS)                       # (nb, ep, cap, D)
    contrib = (back * send["gate"][..., None]
               * send["valid"][..., None]).to(x_loc.dtype)
    out = torch.stack([
        x_loc.new_zeros((t_loc, d)).index_add(0, send["src"][i].reshape(-1),
                                              contrib[i].reshape(-1, d))
        for i in range(nb)])
    return out, aux


def _dp_axes(mesh, batch: int) -> tuple:
    """The mesh's data-parallel axes that split ``batch``, outermost first,
    kept while their product divides it (the reference's
    ``make_rules(..., batch_size=)``)."""
    kept, prod = [], 1
    for a in DP_AXES:
        if a in mesh.axis_names and a != EP_AXIS:
            if batch % (prod * mesh.shape[a]):
                break
            kept.append(a)
            prod *= mesh.shape[a]
    return tuple(kept)


def moe_ep(params: MoE, x: torch.Tensor, cfg: ModelCfg, mesh):
    """Expert-parallel MoE over (B, S, D) on ``mesh``'s ``model`` axis ->
    ((B, S, D), aux): the same output on every rank, aux the mean over the
    mesh's positions."""
    m = cfg.moe
    b, s, d = x.shape
    ep = mesh.shape[EP_AXIS]
    if m.n_experts % ep:
        # EP width must divide experts; the reference falls back to the
        # dense oracle
        return moe_dense(params, x, cfg)
    dp = _dp_axes(mesh, b)
    dpw = mesh.width(dp) if dp else 1
    # decode steps have seq == 1: tokens are only batch-sharded there
    seq_sharded = s % ep == 0 and s > 1
    local = isinstance(mesh, LocalMesh)
    banks = mesh.banks(EP_AXIS)
    part = b // dpw
    if local:
        parts = list(range(dpw))
    else:
        parts = [mesh.batch_part(dp, b)[0] // part] if dp else [0]
    outs, aux_sum = [], 0.0
    for p in parts:
        xg = x[p * part:(p + 1) * part]
        if seq_sharded:
            sl = s // ep
            x_loc = torch.stack([xg[:, j * sl:(j + 1) * sl].reshape(-1, d)
                                 for j in banks])
        else:
            x_loc = xg.reshape(1, -1, d).expand(len(banks), -1, -1)
        out, aux = _ep_banks(params, x_loc, cfg, mesh, banks)
        aux_sum = aux_sum + aux.sum()
        if seq_sharded:
            if not local:
                out = mesh.all_gather(out, EP_AXIS)[0]
            out = out.reshape(ep, part, s // ep, d).transpose(0, 1).reshape(
                part, s, d)
        else:
            out = out[0].reshape(part, s, d)
        outs.append(out)
    out = torch.cat(outs)
    if not local:
        out = mesh.gather_batch(out, dp) if dp else out
        aux_sum = aux_sum.reshape(1)
        for a in (EP_AXIS, *dp):
            aux_sum = mesh.psum(aux_sum, a)
        aux_sum = aux_sum[0]
    # without sequence sharding every bank routed the same tokens, and the
    # reference's pmean counts each bank's aux all the same
    aux = aux_sum / (ep * dpw)
    if m.n_shared:
        out = out + layers.mlp(params.shared, x)
    return out, aux


def moe_block(params: MoE, x: torch.Tensor, cfg: ModelCfg, mesh=None):
    """Dispatch between the EP and dense paths: EP iff ``cfg.parallel.ep``
    and a mesh is given (EP to :data:`MOE_COUNTER`, where it is set)."""
    if cfg.parallel.ep and mesh is not None:
        counter = MOE_COUNTER.get()
        if counter is not None:
            return counter(params, x, cfg, mesh)
        return moe_ep(params, x, cfg, mesh)
    return moe_dense(params, x, cfg)

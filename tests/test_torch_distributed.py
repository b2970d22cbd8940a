"""The sharded ConvDK wrappers and the network forwards on a mesh of CPU
ranks (gloo over ``torch.distributed``), against the port's single-device
ops and forwards, the JAX package's unsharded ops and networks at the same
seed, and its own sharded wrappers at mesh (2, 2); forward and backward.

Every case of one mesh shape runs in one spawn of ranks
(``_rank_cases``, which imports no JAX): the three wrappers with ring and
scatter exits, the sharded-in entries, a scatter that pads an indivisible
c_out, two chained blocks whose layouts match, and a small B0, V3 and V2-S
forward, each with the collectives it counted; then the bf16 cases: the
wrappers' ring and scatter exits and sharded-in entries on bf16 operands
and B0 with ``dtype="bfloat16"``.  The same spawn takes gradients: of a
seeded loss sum(out * r) through every wrapper case (fp32 and bf16), of
``mbconv_block`` and ``separable_block`` routed on the mesh and where they
fall back, and of each network's cross-entropy at seeded labels; the
inputs' gradients come back through the chunks that shard them, the
weights' are summed over the batch axes (``launch.mesh.sum_batch_grads``).
It also checks that every collective keeps its ``grad_fn`` and passes the
cotangents ``launch.mesh``'s rule says, and runs the sequence-parallel
attention (``models.attention``, ``seq_shard``) on RecurrentGemma
``SMOKE``'s MQA heads with its window, dense and chunked, against the
unsharded attention and (at (2, 2)) the JAX package's own route, and
where it must be a no-op; and runs Granite ``SMOKE``'s MoE layer
expert-parallel (``models.moe``; the (2, 2) spawn's four ranks also as one
(1, 4) model axis), forward and backward, against the unsharded layer on
the same batch slices and (at (2, 2)) the JAX package's ``shard_map``
route.  Rank 0 saves the global results;
the tests compare them here within the JAX suite's sharded bar (rtol 1e-4,
atol 1e-4; bf16: its bf16 bar, 2e-2, the absolute part at the output's
scale, each case's error against the absolute 2e-2 printed beside it; the
JAX sharded wrappers' gradients: the JAX suite's gradient bar, 2e-3), and
the counted collectives with the model's.
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.efficientnet_b0 import efficientnet_b0_smoke
from repro_torch.configs.efficientnet_v2_s import efficientnet_v2_s_smoke
from repro_torch.configs.mobilenet_v3_large import mobilenet_v3_large_smoke
from repro_torch.core import perfmodel as tp
from repro_torch.kernels import convdk_sharded as S
from repro_torch.kernels.convdk_fused import convdk_fused_separable
from repro_torch.kernels.convdk_fusedmb import convdk_fusedmb_fused
from repro_torch.kernels.convdk_mbconv import convdk_mbconv_fused
from repro_torch.core import telemetry
from repro_torch.launch.mesh import make_mesh, sum_batch_grads
from repro_torch.configs.granite_moe_3b_a800m import SMOKE as GRANITE_SMOKE
from repro_torch.configs.recurrentgemma_9b import SMOKE as RG_SMOKE
from repro_torch.models import attention as ta
from repro_torch.models import moe as tmoe
from repro_torch.models import mbconv as tm
from repro_torch.models.common import separable_block
from repro_torch.models.param import materialize

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_distributed_fused.py
BF16_RTOL = 2e-2                          # tests/test_kernels.py's bf16 bar
BF16_ATOL = 2e-2                          # ... and its absolute part


def _bf16_report(got, ref, err_msg="", scale=None):
    """(the line reporting ``got`` against the bf16 bar at ``scale``,
    default max|ref|, and against the JAX suite's absolute bf16 bar, atol
    2e-2; the atol at ``scale``)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    if scale is None:
        scale = float(np.abs(ref).max())
    scaled = float((err / np.maximum(BF16_RTOL * scale
                                     + BF16_RTOL * np.abs(ref), 1e-30)).max())
    absolute = float((err / (BF16_ATOL + BF16_RTOL * np.abs(ref))).max())
    return (f"{err_msg}: max|err| {float(err.max()):.3e}, {scaled:.3f} of "
            f"the scaled bar, {absolute:.3f} of the absolute bar"
            f"{'' if absolute <= 1 else ' (MISSES it)'}"), BF16_RTOL * scale


def _close_bf16(got, ref, err_msg="", scale=None, absolute=False):
    """Within the bf16 bar: rtol 2e-2, and atol 2e-2 x ``scale`` (default
    max|ref|).  A mesh sums its ranks' bf16-rounded partials (as the JAX
    package's psum does), whose rounding scales with the partials, not
    with each output element, so the absolute part is taken at the
    output's scale; for a network's gradients, at the gradient tree's
    (``scale``).  Also measured against the JAX suite's absolute bar (atol
    2e-2), which is gated too where ``absolute`` (the gradients, which a
    mesh rounds once, as one device does), else reported: the returned
    line (printed by the callers) and the failure message give max|err|
    and the worst ratio to each bar."""
    line, atol = _bf16_report(got, ref, err_msg, scale)
    np.testing.assert_allclose(got, ref, rtol=BF16_RTOL, atol=atol,
                               err_msg=line)
    if absolute:
        np.testing.assert_allclose(got, ref, rtol=BF16_RTOL, atol=BF16_ATOL,
                                   err_msg=line)
    return line


# the wrapper cases run again on bf16 operands (the SE FCs stay fp32)
BF16_CASES = ("mbconv_retain_ring_allreduce", "mbconv_retain_psum_scatter",
              "mbconv_recompute_ring_allreduce",
              "mbconv_identity_in_psum_scatter", "fusedmb_ring_allreduce",
              "fusedmb_psum_scatter", "separable_in_ring_allreduce",
              "separable_in_psum_scatter", "separable_replicated")
BF16_WEIGHTS = ("x", "xm", "w_exp", "w_dw", "w_proj", "w_projm", "w_conv",
                "w_sdw", "w_pw")
MESHES = {"2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
B, HW, CI, CM, CO, CSE = 4, 9, 8, 16, 12, 2
NETS = {
    "b0": (efficientnet_b0_smoke(width_mult=0.125, num_classes=4),
           tm.efficientnet_b0_def, tm.efficientnet_b0_apply),
    "v3": (mobilenet_v3_large_smoke(), tm.mobilenet_v3_def,
           tm.mobilenet_v3_apply),
    "v2s": (efficientnet_v2_s_smoke(), tm.efficientnet_v2_s_def,
            tm.efficientnet_v2_s_apply),
}
NET_BATCH, NET_SIDE = 2, 16


def _inputs() -> dict:
    """The seeded inputs and weights of every wrapper case (numpy)."""
    rng = np.random.default_rng(7)

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {
        "x": r(B, HW, HW, CI), "xm": r(B, HW, HW, CM),
        "w_exp": r(CI, CM), "w_dw": r(3, 3, CM, scale=0.3),
        "w_se1": r(CM, CSE), "b_se1": r(CSE, scale=0.1),
        "w_se2": r(CSE, CM), "b_se2": r(CM, scale=0.1),
        "w_proj": r(CM, CO), "w_proj9": r(CM, 9), "w_projm": r(CM, CM),
        "w_conv": r(3, 3, CI, CM, scale=0.3), "w_sdw": r(3, 3, CM, scale=0.3),
        "w_pw": r(CM, CO),
    }


def _bf16_inputs(w: dict) -> dict:
    """The inputs as torch tensors, the activations and conv weights cast
    to bf16 (the blocks' storage type), the SE FCs fp32."""
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k in BF16_WEIGHTS
                                      else torch.float32)
            for k, v in w.items()}


def _wrapper_cases(mesh, w):
    """name -> (run on this rank, the layout its output leaves in, global
    c_out, the model's mesh-wide collective words).  ``w`` holds numpy
    arrays or torch tensors (the bf16 cases)."""
    dp, mp = S.conv_mesh_shape(mesh)
    t = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
         for k, v in w.items()}
    se = (t["w_se1"], t["b_se1"], t["w_se2"], t["b_se2"])
    x_rep = S.shard_to_layout(t["x"], mesh)
    xm_rep = S.shard_to_layout(t["xm"], mesh)
    xm_sh = S.shard_to_layout(t["xm"], mesh, "model_sharded")

    def mb_words(c_in, c_out, coll, se=True, layout="replicated"):
        st = tp.sharded_mbconv_traffic(
            tp.MBConvShape(B, HW, HW, c_in, CM, c_out, 3, 1,
                           se_ratio=CSE / c_in if se else 0.0), 3,
            "retain", (dp, mp),
            collective=coll, in_layout=layout)
        return st.collective_words + st.transition_words

    def fmb_words(c_out, coll):
        return tp.sharded_fusedmb_traffic(
            tp.MBConvShape(B, HW, HW, CI, CM, c_out, 3, 1, se_ratio=0.0), 3,
            (dp, mp), collective=coll).collective_words

    def sep_words(layout, coll):
        return tp.sharded_separable_traffic(
            tp.SeparableShape(B, HW, HW, CM, CO, 3, 1), 3, (dp, mp),
            in_layout=layout, collective=coll).collective_words

    def mb(x, w_exp, w_proj, coll, layout="replicated", mode="retain",
           se_w=se, **acts):
        return lambda: S.convdk_mbconv_fused_sharded(
            x, w_exp, t["w_dw"], *se_w, w_proj, mesh=mesh, tile_h=3,
            tile_w=4, mode=mode, collective=coll, in_layout=layout, **acts)

    sharded = {"ring_allreduce": "replicated", "psum_scatter": "model_sharded"}
    cases = {}
    for coll, lay in sharded.items():
        for mode in ("retain", "recompute"):
            cases[f"mbconv_{mode}_{coll}"] = (
                mb(x_rep, t["w_exp"], t["w_proj"], coll, mode=mode), lay, CO,
                mb_words(CI, CO, coll))
        cases[f"mbconv_identity_in_{coll}"] = (
            mb(xm_sh, None, t["w_projm"], coll, "model_sharded",
               exp_act=None), lay, CM,
            mb_words(CM, CM, coll, layout="model_sharded"))
        cases[f"fusedmb_{coll}"] = (
            lambda coll=coll: S.convdk_fusedmb_fused_sharded(
                x_rep, t["w_conv"], t["w_proj"], mesh=mesh, tile_h=3,
                tile_w=4, collective=coll), lay, CO, fmb_words(CO, coll))
        cases[f"separable_in_{coll}"] = (
            lambda coll=coll: S.convdk_fused_separable_sharded(
                xm_sh, t["w_sdw"], t["w_pw"], mesh=mesh, tile_h=3, tile_w=4,
                dw_act="relu", act="relu6", collective=coll,
                in_layout="model_sharded"), lay, CO,
            sep_words("model_sharded", coll))
    cases["mbconv_v3_no_se_recompute"] = (
        mb(x_rep, t["w_exp"], t["w_proj"], "ring_allreduce",
           mode="recompute", se_w=(None,) * 4, exp_act="hard_swish",
           dw_act="hard_swish"), "replicated", CO,
        mb_words(CI, CO, "ring_allreduce", se=False))
    cases["mbconv_v3_se_gate"] = (
        mb(x_rep, t["w_exp"], t["w_proj"], "psum_scatter", exp_act="relu",
           dw_act="relu", se_act="relu", gate_act="hard_sigmoid"),
        "model_sharded", CO, mb_words(CI, CO, "psum_scatter"))
    cases["mbconv_expand_in"] = (
        mb(S.shard_to_layout(t["x"], mesh, "model_sharded"), t["w_exp"],
           t["w_proj"], "ring_allreduce", "model_sharded"), "replicated",
        CO, mb_words(CI, CO, "ring_allreduce", layout="model_sharded"))
    cases["mbconv_pad_scatter"] = (
        mb(x_rep, t["w_exp"], t["w_proj9"], "psum_scatter"),
        "model_sharded", 9, mb_words(CI, 9, "psum_scatter"))
    cases["fusedmb_pad_scatter"] = (
        lambda: S.convdk_fusedmb_fused_sharded(
            x_rep, t["w_conv"], t["w_proj9"], mesh=mesh, tile_h=3, tile_w=4,
            collective="psum_scatter"), "model_sharded", 9,
        fmb_words(9, "psum_scatter"))
    cases["separable_replicated"] = (
        lambda: S.convdk_fused_separable_sharded(
            xm_rep, t["w_sdw"], t["w_pw"], mesh=mesh, tile_h=3, tile_w=4,
            dw_act="relu", act="relu6"), "model_sharded", CO,
        sep_words("replicated", "ring_allreduce"))

    def chain():
        # an expand block leaving c_out-sharded into an identity-expand
        # block taking the slice as it comes: no all-gather between them
        y = S.convdk_mbconv_fused_sharded(
            x_rep, t["w_exp"], t["w_dw"], *se, t["w_projm"], mesh=mesh,
            tile_h=3, tile_w=4, collective="psum_scatter")
        return S.convdk_mbconv_fused_sharded(
            y, None, t["w_dw"], *se, t["w_projm"], mesh=mesh, tile_h=3,
            tile_w=4, exp_act=None, collective="psum_scatter",
            in_layout="model_sharded")

    cases["chain_scatter_into_identity"] = (
        chain, "model_sharded", CM,
        mb_words(CI, CM, "psum_scatter")
        + mb_words(CM, CM, "psum_scatter", layout="model_sharded"))
    return cases


def _counts(mesh) -> dict:
    return {k: (c.calls, c.elements) for k, c in mesh.counts.items()}


# the wrapper cases' global activations; every other input is a weight
ACTIVATIONS = ("x", "xm")


def _cotangent(c_out: int) -> np.ndarray:
    """The seeded r of a wrapper case's loss sum(out * r), at its global
    output's shape (every case keeps H and W)."""
    return np.random.default_rng(100 + c_out).normal(
        size=(B, HW, HW, c_out)).astype(np.float32)


def _leaves(w: dict) -> dict:
    """The inputs as torch leaves that require grad."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(v))
            .detach().clone().requires_grad_() for k, v in w.items()}


def _global_grads(mesh, t: dict, grads) -> dict:
    """One rank's gradients in their global form: the activations' as the
    chunks that sharded them gathered them, the weights' summed over the
    batch axes; fp32 arrays, keyed by input, unused inputs left out."""
    keys = list(t)
    weights = [k for k in keys if k not in ACTIVATIONS]
    summed = dict(zip(weights, sum_batch_grads(
        mesh, [grads[keys.index(k)] for k in weights])))
    out = {}
    for k, g in zip(keys, grads):
        g = summed.get(k, g)
        if g is not None:
            out[k] = g.detach().float().numpy()
    return out


def _wrapper_grads(mesh, w: dict, names=None) -> dict:
    """name -> (the gradients of sum(out * r) through the case, in global
    form; its dtype; the forward's model-axis words before and after the
    backward; the backward's counted collectives)."""
    dp = S.conv_mesh_shape(mesh)[0]
    t = _leaves(w)
    res = {}
    for name in names or _wrapper_cases(mesh, t):
        # built per case: each backward frees its graph, the chunks' too
        run, layout, c_out, _ = _wrapper_cases(mesh, t)[name]
        mesh.reset_counts()
        y = run()
        words = dp * mesh.model_wire_words()
        r = S.shard_to_layout(torch.from_numpy(_cotangent(c_out)).to(y.dtype),
                              mesh, layout)
        grads = torch.autograd.grad(y, list(t.values()), r, allow_unused=True)
        after = dp * mesh.model_wire_words()
        res[name] = dict(
            grads=_global_grads(mesh, t, grads),
            dtypes={k: str(g.dtype) for k, g in zip(t, grads)
                    if g is not None},
            words=words, words_after=after,
            backward={k: v for k, v in _counts(mesh).items()
                      if k.endswith(".backward")})
    return res


def _route_inputs() -> dict:
    """The block routing cases' global input and parameters (seeded): an
    MBConv block (c_mid 32), one whose c_mid (15) a model factor of 2 does
    not divide, a separable block, and one whose c_out (15) it does not
    divide."""
    rng = np.random.default_rng(4)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32))

    gen = torch.Generator().manual_seed(0)
    return {"x": r(B, HW, HW, 16),
            "mb": materialize(tm.mbconv_def(16, 16, k=3, expand_ratio=2),
                              gen, device="cpu"),
            "mb15": materialize(tm.mbconv_def(16, 16, k=3, c_mid=15), gen,
                                device="cpu"),
            "sep": {"dw": r(3, 3, 16, scale=0.3), "pw": r(16, 16)},
            "sep15": {"dw": r(3, 3, 16, scale=0.3), "pw": r(16, 15)}}


# name -> (block, its params, in layout, c_out, shards at model factor 2)
ROUTES = {
    "mbconv": ("mbconv", "mb", "replicated", 16, True),
    "mbconv_sharded_in": ("mbconv", "mb", "model_sharded", 16, True),
    "mbconv_c_mid_15": ("mbconv", "mb15", "replicated", 16, False),
    "separable": ("separable", "sep", "replicated", 16, True),
    "separable_sharded_in": ("separable", "sep", "model_sharded", 16, True),
    "separable_c_out_15": ("separable", "sep15", "replicated", 15, False),
}


def _route(kind, x, params, **kw):
    if kind == "mbconv":
        return tm.mbconv_block(x, params, **kw)
    return separable_block(x, params, dw_act="relu", act="relu6", **kw)


def _block_routes(mesh) -> dict:
    """name -> (the block on the mesh gathered to its global output, its
    out layout, the sharded dispatches it made, the gradients of sum(out *
    r) in global form), ``mbconv_block`` and ``separable_block`` at
    their own schedules."""
    res = {}
    for name, (kind, pkey, layout, c_out, _) in ROUTES.items():
        w = _route_inputs()
        t = _leaves({"x": w["x"], **w[pkey]})
        x = S.shard_to_layout(t["x"], mesh, layout)
        telemetry.reset()
        y, out_layout = _route(kind, x, {k: v for k, v in t.items()
                                         if k != "x"},
                               mesh=mesh, in_layout=layout)
        dispatched = telemetry.get_telemetry().get(
            f"sharded.dispatch.{kind}") or 0
        r = torch.from_numpy(_cotangent(c_out))
        grads = torch.autograd.grad(
            y, list(t.values()), S.shard_to_layout(r, mesh, out_layout),
            allow_unused=True)
        res[name] = dict(
            out=S.gather_global(y.detach(), mesh, out_layout, c_out).numpy(),
            layout=out_layout, dispatched=dispatched,
            grads=_global_grads(mesh, t, grads))
    return res


def _collective_checks(mesh) -> dict:
    """(axis, op) -> (kept a grad_fn, the cotangent it passed is the rule's)
    for every collective and ``chunk`` on each axis of more than one rank,
    on an input that differs by rank; and the batch-axis sum of gradients
    of two dtypes."""
    res = {}
    rank = mesh.rank
    for axis in ("data", "model"):
        n, i = mesh.size(axis), mesh.index(axis)
        if n == 1:
            continue
        w = 3
        g = torch.arange(4.0 * w * n).reshape(4, w * n)   # whole, same
        part = g[:, i * w:(i + 1) * w]                     # this rank's
        t = (torch.arange(4.0 * w * n).reshape(4, w * n) * 0.5
             + rank).requires_grad_()
        ts = (torch.arange(4.0 * w).reshape(4, w) + rank).requires_grad_()
        cases = {"all_reduce": (lambda: mesh.all_reduce(t, axis), t, g, g),
                 "reduce_scatter": (
                     lambda: mesh.reduce_scatter(t, axis, dim=1), t, part, g),
                 "all_gather": (lambda: mesh.all_gather(ts, axis, dim=1), ts,
                                g, part),
                 "chunk": (lambda: mesh.chunk(t, axis, dim=1), t, part, g)}
        for op, (fn, leaf, cot, want) in cases.items():
            out = fn()
            got, = torch.autograd.grad(out, leaf, cot)
            res[(axis, op)] = (out.grad_fn is not None,
                               bool(torch.equal(got, want)))
    dp, di = S.conv_mesh_shape(mesh)[0], mesh.index("data")
    grads = [torch.full((3, 2), di + 1.0), None,
             torch.full((5,), di + 1.0, dtype=torch.bfloat16)]
    mesh.reset_counts()
    summed = sum_batch_grads(mesh, grads)
    total = dp * (dp + 1) / 2
    res["sum_batch_grads"] = (
        summed[1] is None
        and bool(torch.equal(summed[0], torch.full((3, 2), total)))
        and summed[2].dtype == torch.bfloat16
        and bool(torch.equal(summed[2].float(), torch.full((5,), total))),
        _counts(mesh))
    return res


# sequence-parallel attention: RecurrentGemma SMOKE's heads (4 query
# heads over 1 KV head, head_dim 16) and window 8, at batch 2 x 16 tokens
SA_B, SA_S = 2, 16
SA_CASES = {"dense": {}, "chunked": {"q_chunk": 4, "kv_chunk": 3}}


def _seq_attn_cfg(**kw) -> ta.AttnConfig:
    return dataclasses.replace(RG_SMOKE, seq_shard_attn=True,
                               **kw).attn_cfg(RG_SMOKE.window)


def _seq_attn_inputs() -> dict:
    """Seeded numpy inputs: x and the four projections (``sa_*``), and q,
    k, v, for ``_seq_parallel_sdpa`` alone (``sq_*``)."""
    rng = np.random.default_rng(11)
    d, hd = RG_SMOKE.d_model, RG_SMOKE.head_dim
    h, kv = RG_SMOKE.n_heads, RG_SMOKE.n_kv_heads

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"sa_x": r(SA_B, SA_S, d), "sa_q": r(d, h * hd, scale=d ** -0.5),
            "sa_k": r(d, kv * hd, scale=d ** -0.5),
            "sa_v": r(d, kv * hd, scale=d ** -0.5),
            "sa_o": r(h * hd, d, scale=(h * hd) ** -0.5),
            "sq_q": r(SA_B, SA_S, h, hd), "sq_k": r(SA_B, SA_S, kv, hd),
            "sq_v": r(SA_B, SA_S, kv, hd)}


def _seq_attn_params(w: dict) -> dict:
    return {n: {"w": torch.from_numpy(w["sa_" + n])} for n in "qkvo"}


def _seq_attn_cases(mesh) -> dict:
    """This rank's part of each sequence-parallel case, gathered over the
    batch to its global form, with the collectives it counted: the
    attention layer (``seq_shard`` on, dense and chunked), the route
    alone on q, k, v, and the no-op cases (``seq_shard`` off; two KV
    heads, which a model axis of 2 divides)."""
    w = _seq_attn_inputs()
    params = _seq_attn_params(w)
    x = mesh.chunk(torch.from_numpy(w["sa_x"]), "data", dim=0)

    def run(fn):
        mesh.reset_counts()
        out = fn()
        counts = _counts(mesh)
        return dict(out=mesh.all_gather(out.contiguous(), "data",
                                        dim=0).numpy(), counts=counts)

    res = {}
    for name, kw in SA_CASES.items():
        cfg = _seq_attn_cfg(**kw)
        res[name] = run(lambda: ta.attention(params, x, cfg, mesh=mesh))
        q, k, v = (mesh.chunk(torch.from_numpy(w["sq_" + n]), "data", dim=0)
                   for n in "qkv")
        res["sdpa_" + name] = run(lambda: ta._seq_parallel_sdpa(
            mesh, q, k, v, torch.arange(SA_S), cfg, RG_SMOKE.head_dim ** -0.5,
            bool(kw)))
    off = _seq_attn_cfg()._replace(seq_shard=False)
    res["off"] = run(lambda: ta.attention(params, x, off, mesh=mesh))
    # two KV heads: the projections of k and v take 32 columns
    two = _seq_attn_cfg(n_kv_heads=2)
    p2 = dict(params, k={"w": params["k"]["w"].repeat(1, 2)},
              v={"w": params["v"]["w"].repeat(1, 2)})
    res["kv2"] = run(lambda: ta.attention(p2, x, two, mesh=mesh))
    return res


# expert-parallel MoE: Granite SMOKE's layer (5 experts padded to 8, top-2)
# at the default capacity, on 4 sequences of 8 tokens that share a mean
# direction, so that each data slice drops pairs
MOE_B, MOE_S = 4, 8
MOE_KEYS = ("router", "gate", "up", "down")
MOE_CFG = GRANITE_SMOKE.moe_cfg()
MOE_TOL = 1e-4                   # x max|ref|, + 1e-6


def _moe_inputs() -> dict:
    """Seeded numpy inputs (``moe_*``): x, the four weights and the
    cotangent r of the loss sum(out * r)."""
    rng = np.random.default_rng(13)
    e, d, f = MOE_CFG.n_experts_pad, MOE_CFG.d_model, MOE_CFG.d_ff

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"moe_x": r(MOE_B, MOE_S, d) + r(d),
            "moe_router": r(d, e, scale=d ** -0.5),
            "moe_gate": r(e, d, f, scale=d ** -0.5),
            "moe_up": r(e, d, f, scale=d ** -0.5),
            "moe_down": r(e, f, d, scale=f ** -0.5),
            "moe_r": r(MOE_B, MOE_S, d)}


def _moe_cases(mesh) -> dict:
    """This rank's expert-parallel layer on its batch slice (its capacity
    that slice's): the output gathered over the batch, the forward's
    collectives, the pairs it dropped, and the gradients of sum(out * r)
    (x's gathered, the weights' summed over the batch axes) with the
    backward's collectives."""
    w = _moe_inputs()
    params = {n: torch.from_numpy(w["moe_" + n]).requires_grad_()
              for n in MOE_KEYS}
    x = mesh.chunk(torch.from_numpy(w["moe_x"]), "data",
                   dim=0).clone().requires_grad_()
    r = mesh.chunk(torch.from_numpy(w["moe_r"]), "data", dim=0)
    mesh.reset_counts()
    with tmoe.recording() as drops:
        out = tmoe.moe_apply(params, x, MOE_CFG, mesh=mesh)
    counts = _counts(mesh)
    mesh.reset_counts()
    (out * r).sum().backward()
    grads = sum_batch_grads(mesh, [params[n].grad for n in MOE_KEYS])
    return dict(out=mesh.all_gather(out.detach(), "data", dim=0).numpy(),
                counts=counts, backward_counts=_counts(mesh),
                dropped=[int(d.dropped) for d in drops],
                x_grad=mesh.all_gather(x.grad, "data", dim=0).numpy(),
                grads={n: g.numpy() for n, g in zip(MOE_KEYS, grads)})


def _rank_cases(rank, shape, axes, port, out_path):
    """One rank of one mesh: every case, rank 0 saving the results."""
    torch.set_num_threads(1)
    mesh = make_mesh(shape, axes, device="cpu",
                     init_method=f"tcp://localhost:{port}", rank=rank,
                     world_size=math.prod(shape))
    try:
        dp = S.conv_mesh_shape(mesh)[0]
        res = {"wrappers": {}, "networks": {}}
        for name, (run, layout, c_out, words) in _wrapper_cases(
                mesh, _inputs()).items():
            mesh.reset_counts()
            out = run()
            counted = _counts(mesh)
            wire = dp * mesh.model_wire_words()
            res["wrappers"][name] = dict(
                out=S.gather_global(out, mesh, layout, c_out).numpy(),
                counts=counted, wire_words=wire, model_words=words)
        cases = _wrapper_cases(mesh, _bf16_inputs(_inputs()))
        res["bf16_wrappers"] = {}
        for name in BF16_CASES:
            run, layout, c_out, words = cases[name]
            mesh.reset_counts()
            out = run()
            counted = _counts(mesh)
            wire = dp * mesh.model_wire_words()
            res["bf16_wrappers"][name] = dict(
                out=S.gather_global(out, mesh, layout, c_out).float().numpy(),
                dtype=str(out.dtype), counts=counted, wire_words=wire,
                model_words=words)
        res["grads"] = _wrapper_grads(mesh, _inputs())
        res["bf16_grads"] = _wrapper_grads(mesh, _bf16_inputs(_inputs()),
                                           BF16_CASES)
        res["routes"] = _block_routes(mesh)
        res["collectives"] = _collective_checks(mesh)
        res["seq_attn"] = _seq_attn_cases(mesh)
        res["moe"] = _moe_cases(mesh)
        if shape == (2, 2):
            # the same four ranks as one model axis
            res["moe_1x4"] = _moe_cases(make_mesh((1, 4), device="cpu"))
        for name, (cfg, def_fn, apply) in _net_runs():
            params, images, labels = _net_inputs(cfg, def_fn)
            plan = tm.network_plan(tm_specs(name.split("_")[0], cfg),
                                   NET_BATCH, NET_SIDE, NET_SIDE,
                                   S.conv_mesh_shape(mesh),
                                   tm.dtype_bytes(cfg.dtype))
            mesh.reset_counts()
            logits = apply(params, images, cfg, mesh=mesh)
            model_counts = {k: v for k, v in _counts(mesh).items()
                            if k.endswith(".model")}
            words = dp * mesh.model_wire_words()
            res["networks"][name] = dict(
                grads=_net_grads(mesh, params, logits, labels),
                logits=logits.detach().float().numpy(),
                dtype=str(logits.dtype),
                counts=model_counts, wire_words=words,
                model_words=plan.interconnect_words,
                gathering_boundaries=sum(
                    1 for a, p in zip(
                        (plan.stem_layout,)
                        + tuple(q.out_layout for q in plan.blocks),
                        plan.blocks + (None,))
                    if a == "model_sharded"
                    and (p is None or p.in_layout == "replicated")),
                layouts=[(p.in_layout, p.out_layout) for p in plan.blocks],
                stem_layout=plan.stem_layout)
        if rank == 0:
            torch.save(res, out_path)
    finally:
        mesh.close()


def _net_inputs(cfg, def_fn):
    """A network's seeded parameters (leaves that require grad), images and
    labels."""
    params = materialize(def_fn(cfg), torch.Generator().manual_seed(3),
                         device="cpu")
    for leaf in _flat(params).values():
        leaf.requires_grad_()
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.random((NET_BATCH, NET_SIDE, NET_SIDE, 3),
                                         np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, NET_BATCH))
    return params, images, labels


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _net_grads(mesh, params: dict, logits: torch.Tensor,
               labels: torch.Tensor) -> dict:
    """The parameters' gradients of the trainer's loss (cross-entropy of
    the fp32 logits at ``labels``), summed over the batch axes on a mesh
    (``mesh`` None: one device); name -> fp32 array."""
    flat = _flat(params)
    grads = torch.autograd.grad(F.cross_entropy(logits.float(), labels),
                                list(flat.values()))
    if mesh is not None:
        grads = sum_batch_grads(mesh, grads)
    return {k: g.float().numpy() for k, g in zip(flat, grads)}


def _net_runs():
    """(name, (config, def, apply)) of the mesh forwards: the three smoke
    networks in fp32 and B0 again in bf16 ("b0_bf16")."""
    cfg, def_fn, apply = NETS["b0"]
    return list(NETS.items()) + [
        ("b0_bf16", (dataclasses.replace(cfg, dtype="bfloat16"), def_fn,
                     apply))]


def tm_specs(name, cfg):
    return {"b0": tm.effnet_block_specs, "v3": tm.mobilenet_v3_specs,
            "v2s": tm.effnet_v2_block_specs}[name](cfg)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Each mesh shape's results, one spawn of ranks per shape."""
    out = {}
    tmp = tmp_path_factory.mktemp("mesh")
    for name, (shape, axes) in MESHES.items():
        path = tmp / f"{name}.pt"
        torch.multiprocessing.spawn(
            _rank_cases, args=(shape, axes, _free_port(), str(path)),
            nprocs=math.prod(shape))
        out[name] = torch.load(path, weights_only=False)
    return out


def _single_device_cases(w: dict) -> dict:
    """name -> the single-device op of every wrapper case on the global
    inputs ``w`` (torch tensors)."""
    se = (w["w_se1"], w["b_se1"], w["w_se2"], w["b_se2"])

    def mb(x, w_exp, w_proj, mode="retain", se_on=True, **acts):
        return lambda: convdk_mbconv_fused(
            x, w_exp, w["w_dw"], *(se if se_on else (None,) * 4), w_proj,
            tile_h=3, tile_w=4, mode=mode, **acts)

    def sep():
        return convdk_fused_separable(w["xm"], w["w_sdw"], w["w_pw"],
                                      tile_h=3, tile_w=4, dw_act="relu",
                                      act="relu6")

    cases = {}
    for coll in ("ring_allreduce", "psum_scatter"):
        for mode in ("retain", "recompute"):
            cases[f"mbconv_{mode}_{coll}"] = mb(w["x"], w["w_exp"],
                                                w["w_proj"], mode)
        cases[f"mbconv_identity_in_{coll}"] = mb(w["xm"], None, w["w_projm"],
                                                 exp_act=None)
        cases[f"fusedmb_{coll}"] = lambda: convdk_fusedmb_fused(
            w["x"], w["w_conv"], w["w_proj"], tile_h=3, tile_w=4)
        cases[f"separable_in_{coll}"] = sep
    cases["mbconv_v3_no_se_recompute"] = mb(
        w["x"], w["w_exp"], w["w_proj"], "recompute", se_on=False,
        exp_act="hard_swish", dw_act="hard_swish")
    cases["mbconv_v3_se_gate"] = mb(w["x"], w["w_exp"], w["w_proj"],
                                    exp_act="relu", dw_act="relu",
                                    se_act="relu", gate_act="hard_sigmoid")
    cases["mbconv_expand_in"] = mb(w["x"], w["w_exp"], w["w_proj"])
    cases["mbconv_pad_scatter"] = mb(w["x"], w["w_exp"], w["w_proj9"])
    cases["fusedmb_pad_scatter"] = lambda: convdk_fusedmb_fused(
        w["x"], w["w_conv"], w["w_proj9"], tile_h=3, tile_w=4)
    cases["separable_replicated"] = sep
    first = mb(w["x"], w["w_exp"], w["w_projm"])
    cases["chain_scatter_into_identity"] = lambda: mb(
        first(), None, w["w_projm"], exp_act=None)()
    return cases


def _single_device_grads(w: dict, names) -> dict:
    """name -> the gradients of sum(out * r) through the single-device op,
    fp32 arrays keyed by input (unused inputs left out)."""
    res = {}
    for name in names:
        t = _leaves(w)
        y = _single_device_cases(t)[name]()
        r = torch.from_numpy(_cotangent(y.shape[-1])).to(y.dtype)
        grads = torch.autograd.grad(y, list(t.values()), r, allow_unused=True)
        res[name] = {k: g.float().numpy() for k, g in zip(t, grads)
                     if g is not None}
    return res


@pytest.fixture(scope="module")
def port_refs():
    """The single-device results of every wrapper case and network, and
    their gradients."""
    w = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    cases = _single_device_cases(w)
    ref = {k: f() for k, f in cases.items()}
    nets = {}
    for name, (cfg, def_fn, apply) in _net_runs():
        params, images, labels = _net_inputs(cfg, def_fn)
        logits = apply(params, images, cfg)
        nets[name] = (params, images, logits.detach(),
                      _net_grads(None, params, logits, labels))
    return ({k: v.numpy() for k, v in ref.items()}, nets,
            _single_device_grads(_inputs(), cases))


@pytest.fixture(scope="module")
def port_refs_bf16():
    """The single-device results of the bf16 wrapper cases, on the same
    bf16 operands (fp32 arrays of the bf16 outputs), and their
    gradients."""
    w = _bf16_inputs(_inputs())
    cases = _single_device_cases(w)
    ref = {k: cases[k]() for k in BF16_CASES}
    assert all(v.dtype == torch.bfloat16 for v in ref.values())
    return ({k: v.float().numpy() for k, v in ref.items()},
            _single_device_grads(w, BF16_CASES))


@pytest.fixture(scope="module")
def route_refs():
    """The routing cases' blocks without a mesh: output and gradients."""
    res = {}
    for name, (kind, pkey, _, c_out, _) in ROUTES.items():
        w = _route_inputs()
        t = _leaves({"x": w["x"], **w[pkey]})
        y, _ = _route(kind, t["x"], {k: v for k, v in t.items() if k != "x"})
        grads = torch.autograd.grad(y, list(t.values()),
                                    torch.from_numpy(_cotangent(c_out)),
                                    allow_unused=True)
        res[name] = (y.detach().numpy(),
                     {k: g.numpy() for k, g in zip(t, grads)
                      if g is not None})
    return res


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_wrappers_match_single_device(mesh_runs, port_refs, mesh):
    """The three wrappers, ring and scatter exits, the sharded-in entries
    (identity free, a real expand gathered), the padded scatters and the
    chained pair, gathered to their global form, equal the single-device
    ops within the sharded bar."""
    refs = port_refs[0]
    got = mesh_runs[mesh]["wrappers"]
    assert set(got) == set(refs)
    for name, r in got.items():
        np.testing.assert_allclose(r["out"], refs[name], err_msg=name, **TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_counted_collectives_equal_the_model(mesh_runs, mesh):
    """Every case's counted model-axis collectives move the words
    ``core.perfmodel`` prices; the SE squeeze is the one all-reduce beside
    a scatter exit, the separable replicated entry moves nothing, and the
    chained pair crosses its boundary with no all-gather."""
    (dp, mp) = S.conv_mesh_shape(types.SimpleNamespace(
        shape=dict(zip(MESHES[mesh][1], MESHES[mesh][0]))))
    got = mesh_runs[mesh]["wrappers"]
    for name, r in got.items():
        assert r["wire_words"] == r["model_words"], name
    if mp == 1:
        assert all(not any(k.endswith(".model") for k in r["counts"])
                   for r in got.values())
        return
    assert not any(k.endswith(".model")
                   for k in got["separable_replicated"]["counts"])
    squeeze = got["mbconv_retain_psum_scatter"]["counts"]
    assert squeeze["all_reduce.model"] == (1, B // dp * CSE)
    assert squeeze["reduce_scatter.model"] == (1, B // dp * HW * HW * CO)
    chain = got["chain_scatter_into_identity"]["counts"]
    assert "all_gather.model" not in chain
    assert chain["reduce_scatter.model"][0] == 2
    assert chain["all_reduce.model"][0] == 2
    assert got["mbconv_expand_in"]["counts"]["all_gather.model"][0] == 1
    # without SE the projection is the one collective
    assert got["mbconv_v3_no_se_recompute"]["counts"] == {
        "all_reduce.model": (1, B // dp * HW * HW * CO)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("net", list(NETS) + ["b0_bf16"])
def test_network_forwards_on_the_mesh(mesh_runs, port_refs, mesh, net):
    """B0, MobileNet-V3 and V2-S on the mesh give the single-device
    logits (B0 in bf16 too, at the bf16 bar, its logits bf16); their
    counted collectives are the plan's words (at the config's dtype),
    all-gathering only where a sharded boundary meets a replicated
    entry."""
    nets = port_refs[1]
    r = mesh_runs[mesh]["networks"][net]
    ref = nets[net][2]
    assert r["dtype"] == str(ref.dtype)
    if net in NETS:
        np.testing.assert_allclose(r["logits"], ref.numpy(), **TOL)
    else:
        print(_close_bf16(r["logits"], ref.float().numpy(),
                          f"{mesh} {net} logits"))
    assert r["wire_words"] == r["model_words"]
    gathers = r["counts"].get("all_gather.model", (0, 0))[0]
    # the split ring of an identity block with a sharded input and a
    # residual gathers inside the block: one more all-gather each
    cfg = dict(_net_runs())[net][0]
    split = sum(1 for (i, o), sp in zip(r["layouts"],
                                        tm_specs(net.split("_")[0], cfg))
                if i == "model_sharded" and o == "replicated"
                and sp.has_residual)
    assert gathers == r["gathering_boundaries"] + split


@pytest.mark.parametrize("mesh", list(MESHES))
def test_bf16_wrappers_match_single_device(mesh_runs, port_refs_bf16,
                                           mesh):
    """The wrappers on bf16 operands: bf16 out, each gathered result within
    the bf16 bar of the single-device op on the same operands, and the
    counted model-axis collectives the words the model prices (the SE
    squeeze all-reduced in fp32, the projection and pointwise partials at
    bf16)."""
    got = mesh_runs[mesh]["bf16_wrappers"]
    assert set(got) == set(BF16_CASES)
    for name, r in got.items():
        assert r["dtype"] == "torch.bfloat16", name
        print(_close_bf16(r["out"], port_refs_bf16[0][name],
                          f"{mesh} {name}"))
        assert r["wire_words"] == r["model_words"], name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_wrapper_grads_match_single_device(mesh_runs, port_refs,
                                                   mesh):
    """Every wrapper case's gradients of sum(out * r), the weights' summed
    over the batch axes and the inputs' gathered by the chunks that
    sharded them, equal the single-device op's within the sharded bar:
    no gradient is lost or counted twice across "model"."""
    refs = port_refs[2]
    got = mesh_runs[mesh]["grads"]
    assert set(got) == set(refs)
    for name, r in got.items():
        assert set(r["grads"]) == set(refs[name]), name
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g, refs[name][k],
                                       err_msg=f"{name} {k}", **TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_bf16_wrapper_grads_match_single_device(mesh_runs, port_refs_bf16,
                                                mesh):
    """The bf16 wrapper cases' gradients, at the types of the operands
    (bf16 but the SE FCs' fp32), within the bf16 bar of the single-device
    op's, whose backward follows JAX's ``custom_vjp`` at the bf16
    operands, and within the JAX suite's absolute bf16 bar of it: the
    weights the oracle widens sum over the batch axes in fp32 and round
    once, as one device rounds them."""
    refs = port_refs_bf16[1]
    got = mesh_runs[mesh]["bf16_grads"]
    assert set(got) == set(BF16_CASES)
    for name, r in got.items():
        assert set(r["grads"]) == set(refs[name]), name
        for k, g in r["grads"].items():
            fp32 = k.startswith(("w_se", "b_se"))
            assert r["dtypes"][k] == ("torch.float32" if fp32
                                      else "torch.bfloat16"), (name, k)
            print(_close_bf16(g, refs[name][k], f"{mesh} {name} {k}",
                              absolute=True))


# the cases whose backward gathers nothing over "model": a replicated
# input and a ring exit (the cotangent whole on every rank)
RING_REPLICATED = ("mbconv_retain_ring_allreduce",
                   "mbconv_recompute_ring_allreduce", "fusedmb_ring_allreduce",
                   "mbconv_v3_no_se_recompute")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_backward_counts_apart_from_the_forward(mesh_runs, mesh):
    """A backward leaves the forward's model-axis words as the model prices
    them; its own collectives count under ``.backward``: the output
    gathered after a scatter exit (and a sharded input gathered) over
    "model", the inputs' chunks over the batch axes, and over "data" one
    all-reduce of the weights' gradients per dtype, and in the bf16 cases
    one more, the wrapper's own fp32 sum of the bf16 weights its oracle
    widens."""
    (dp, mp) = S.conv_mesh_shape(types.SimpleNamespace(
        shape=dict(zip(MESHES[mesh][1], MESHES[mesh][0]))))
    for kind in ("grads", "bf16_grads"):
        for name, r in mesh_runs[mesh][kind].items():
            words = mesh_runs[mesh]["wrappers"][name]["model_words"]
            assert r["words"] == r["words_after"] == words, (kind, name)
            back = r["backward"]
            assert ("all_gather.model.backward" in back) == (
                mp > 1 and name not in RING_REPLICATED), (kind, name, back)
            assert ("all_reduce.data.backward" in back) == (dp > 1), back
            if dp > 1:
                weights = {d for k, d in r["dtypes"].items()
                           if k not in ACTIVATIONS}
                once = int(kind == "bf16_grads")
                assert back["all_reduce.data.backward"][0] == \
                    len(weights) + once, (kind, name, back)
    back = mesh_runs[mesh]["grads"]["separable_in_psum_scatter"]["backward"]
    if mp > 1:
        # the cotangent's slices and the input's, gathered over "model"
        assert back["all_gather.model.backward"][0] == 3


@pytest.mark.parametrize("mesh", list(MESHES))
def test_block_routes_match_the_mesh_free_blocks(mesh_runs, route_refs,
                                                 mesh):
    """The port's twin of the JAX suite's routing test: ``mbconv_block``
    and ``separable_block`` with a mesh route through the sharded wrappers
    where the channel grid divides (replicated and model-sharded
    arrivals), fall back to the single-card kernels on the rank's batch
    where it does not (c_mid 15, c_out 15 at a model factor of 2), and give
    the mesh-free block's output and gradients either way.  (A global
    batch the data factor does not divide cannot reach a port block, which
    takes the rank's batch slice: the network raises on it, in
    ``test_sharded_wrappers_reject_bad_grids``.)"""
    mp = MESHES[mesh][0][-1]
    got = mesh_runs[mesh]["routes"]
    assert set(got) == set(ROUTES)
    for name, (kind, _, layout, _, shards) in ROUTES.items():
        r, (want, want_grads) = got[name], route_refs[name]
        assert r["dispatched"] == (1 if shards or mp == 1 else 0), name
        if kind == "separable":
            sliced = mp > 1 and shards and layout == "replicated"
            assert r["layout"] == ("model_sharded" if sliced
                                   else "replicated"), name
        np.testing.assert_allclose(r["out"], want, err_msg=name, **TOL)
        assert set(r["grads"]) == set(want_grads), name
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g, want_grads[k],
                                       err_msg=f"{name} {k}", **TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("net", list(NETS) + ["b0_bf16"])
def test_network_grads_on_the_mesh(mesh_runs, port_refs, mesh, net):
    """Each network's parameter gradients of the trainer's loss through
    the mesh forward (every wrapper, collective and chunk on its route),
    summed over the batch axes, equal the single device's: in fp32 within
    the sharded bar and within 1e-4 of each tensor's own largest gradient
    (which holds the SE FCs' gradients deep in the chain, near 1e-10,
    too); B0 in bf16 at the bf16 bar taken at the gradient tree's scale
    (each block's rounding reaches the cotangents of every block before
    it) and within the JAX suite's absolute bf16 bar, each tensor's error
    against its own scale printed."""
    ref = port_refs[1][net][3]
    got = mesh_runs[mesh]["networks"][net]["grads"]
    assert set(got) == set(ref)
    tree = max(float(np.abs(v).max()) for v in ref.values())
    for k, g in got.items():
        if net in NETS:
            np.testing.assert_allclose(g, ref[k], err_msg=k, **TOL)
            own = float(np.abs(ref[k]).max())
            assert float(np.abs(g - ref[k]).max()) <= TOL["rtol"] * own, k
        else:
            print(_close_bf16(g, ref[k], f"{mesh} {net} {k} (tree scale)",
                              scale=tree, absolute=True))
            print(_bf16_report(g, ref[k], f"{mesh} {net} {k} (own scale, "
                                          "not gated)")[0])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_collective_keeps_its_grad_fn(mesh_runs, mesh):
    """On every axis of more than one rank, ``all_reduce``,
    ``reduce_scatter``, ``all_gather`` and ``chunk`` return a tensor with a
    ``grad_fn`` for an input that requires grad, and pass the cotangent
    the rule gives (identity, all-gather, the rank's slice, all-gather);
    ``sum_batch_grads`` sums over the batch axes per dtype, keeps
    ``None``, and counts one all-reduce per dtype."""
    dp, mp = (math.prod(MESHES[mesh][0][:-1]), MESHES[mesh][0][-1])
    res = mesh_runs[mesh]["collectives"]
    want = {(axis, op) for axis, n in (("data", dp), ("model", mp)) if n > 1
            for op in ("all_reduce", "reduce_scatter", "all_gather",
                       "chunk")}
    assert set(res) - {"sum_batch_grads"} == want
    for key in want:
        assert res[key] == (True, True), key
    ok, counts = res["sum_batch_grads"]
    assert ok
    assert counts == ({"all_reduce.data.backward": (2, 11)} if dp > 1
                      else {})


def test_plans_shard_the_identity_entries(mesh_runs):
    """On a model axis the plan keeps the stem sharded into B0's and V3's
    identity-expand block 0; V2-S's Fused-MBConv entries stay
    replicated."""
    for mesh in ("1x2", "2x2", "2x1x2"):
        nets = mesh_runs[mesh]["networks"]
        for net in ("b0", "v3"):
            assert nets[net]["stem_layout"] == "model_sharded", (mesh, net)
            assert nets[net]["layouts"][0][0] == "model_sharded"
        specs = tm_specs("v2s", NETS["v2s"][0])
        assert all(lay[0] == "replicated" for lay, sp in
                   zip(nets["v2s"]["layouts"], specs)
                   if sp.family == "fusedmb")
    for net in NETS:
        assert mesh_runs["2x1"]["networks"][net]["stem_layout"] == \
            "replicated"


def test_sharded_wrappers_reject_bad_grids():
    """A mesh without both axes, a c_mid or c_in the model factor does not
    divide, a sharded input to Fused-MBConv and a batch the data factor
    does not divide all raise before any collective; a gradient goes
    through (the single-device op's on a one-rank mesh)."""
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2}, dp=2, mp=2)
    x = torch.zeros(2, 5, 5, 8)
    w_dw, w_proj = torch.zeros(3, 3, 15), torch.zeros(15, 8)
    assert S.can_shard_fused(mesh, 4, 16)
    assert not S.can_shard_fused(mesh, 3, 16)
    assert not S.can_shard_fused(mesh, 4, 15)
    assert not S.can_shard_fused(types.SimpleNamespace(shape={"data": 2}),
                                 4, 16)
    with pytest.raises(ValueError, match="c_mid 15"):
        S.convdk_mbconv_fused_sharded(x, torch.zeros(8, 15), w_dw, None,
                                      None, None, None, w_proj, mesh=mesh)
    with pytest.raises(ValueError, match="'model'"):
        S.convdk_mbconv_fused_sharded(
            x, torch.zeros(8, 16), torch.zeros(3, 3, 16), None, None, None,
            None, torch.zeros(16, 8),
            mesh=types.SimpleNamespace(shape={"data": 2}))
    with pytest.raises(ValueError, match="replicated arrivals only"):
        S.convdk_fusedmb_fused_sharded(
            x, torch.zeros(3, 3, 8, 16), torch.zeros(16, 8), mesh=mesh,
            in_layout="model_sharded")
    with pytest.raises(ValueError, match="c_out 6"):
        S.convdk_fused_separable_sharded(
            torch.zeros(2, 5, 5, 8), torch.zeros(3, 3, 8), torch.zeros(8, 6),
            mesh=types.SimpleNamespace(shape={"data": 2, "model": 4}))
    with pytest.raises(ValueError, match="c_in 12"):
        S.convdk_fused_separable_sharded(
            torch.zeros(2, 5, 5, 3), torch.zeros(3, 3, 6), torch.zeros(6, 8),
            mesh=types.SimpleNamespace(shape={"data": 2, "model": 4}),
            in_layout="model_sharded")
    # a gradient no longer raises: on a one-rank mesh the wrapper's
    # backward is the single-device op's, bit for bit
    rng = np.random.default_rng(9)
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((2, 5, 5, 8), (3, 3, 8, 16), (16, 8))]
    leaves = [a.clone().requires_grad_() for a in args]
    one = make_mesh((1, 1), device="cpu",
                    init_method=f"tcp://localhost:{_free_port()}", rank=0,
                    world_size=1)
    try:
        y = S.convdk_fusedmb_fused_sharded(*leaves, mesh=one, tile_h=3,
                                           tile_w=4)
        got = torch.autograd.grad((y ** 2).sum(), leaves)
    finally:
        one.close()
    assert type(y.grad_fn).__name__ == "_ShardedFnBackward"
    leaves = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad((convdk_fusedmb_fused(
        *leaves, tile_h=3, tile_w=4) ** 2).sum(), leaves)
    assert all(torch.equal(g, r) for g, r in zip(got, want))
    cfg, def_fn, apply = NETS["b0"]
    params = materialize(def_fn(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(ValueError, match="batch 3"):
        apply(params, torch.zeros(3, 16, 16, 3), cfg, mesh=mesh)


def test_make_mesh_needs_a_backend_that_fits():
    """``make_mesh`` raises without CUDA unless asked for the CPU, takes
    gloo for the CPU, checks the world against the shape, and never picks
    gloo for CUDA tensors by itself."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((1, 1))
    with pytest.raises(ValueError, match="gloo"):
        make_mesh((1, 1), device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="init_method"):
        make_mesh((1, 1), device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((1, 2), device="cpu", init_method="tcp://localhost:1",
                  rank=0, world_size=1)
    with pytest.raises(ValueError, match="axes"):
        make_mesh((1, 1), ("model", "data"), device="cpu")


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _jax_op_refs():
    """The JAX package's unsharded ops on the wrapper cases' inputs (the
    Pallas kernels in interpret mode, as its tests run them)."""
    import jax.numpy as jnp
    from repro.kernels import (
        convdk_fused_separable as j_sep,
        convdk_fusedmb_fused as j_fmb,
        convdk_mbconv_fused as j_mb,
    )

    w = {k: jnp.asarray(v) for k, v in _inputs().items()}
    se = (w["w_se1"], w["b_se1"], w["w_se2"], w["b_se2"])
    eye = jnp.eye(CM, dtype=jnp.float32)
    return {
        "mbconv_retain_ring_allreduce": j_mb(
            w["x"], w["w_exp"], w["w_dw"], *se, w["w_proj"], tile_h=3),
        "mbconv_identity_in_ring_allreduce": j_mb(
            w["xm"], eye, w["w_dw"], *se, w["w_projm"], tile_h=3,
            exp_act=None),
        "fusedmb_ring_allreduce": j_fmb(w["x"], w["w_conv"], w["w_proj"],
                                        tile_h=3),
        "separable_in_ring_allreduce": j_sep(
            w["xm"], w["w_sdw"], w["w_pw"], tile_h=3, dw_act="relu",
            act="relu6"),
        "mbconv_pad_scatter": j_mb(w["x"], w["w_exp"], w["w_dw"], *se,
                                   w["w_proj9"], tile_h=3),
    }


def test_wrappers_match_the_jax_ops(mesh_runs):
    refs = _jax_op_refs()
    for mesh in MESHES:
        got = mesh_runs[mesh]["wrappers"]
        for name, ref in refs.items():
            np.testing.assert_allclose(got[name]["out"], np.asarray(ref),
                                       err_msg=f"{mesh} {name}", **TOL)


_JAX_SHARDED = textwrap.dedent("""
    import functools, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.kernels import (convdk_fused_separable_sharded,
                               convdk_fusedmb_fused_sharded,
                               convdk_mbconv_fused_sharded)
    w = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
    mesh = make_mesh((2, 2), ("data", "model"))
    SE = ("w_se1", "b_se1", "w_se2", "b_se2")
    mb = functools.partial(convdk_mbconv_fused_sharded, mesh=mesh, tile_h=3)
    fmb = functools.partial(convdk_fusedmb_fused_sharded, mesh=mesh,
                            tile_h=3)
    sep = functools.partial(convdk_fused_separable_sharded, mesh=mesh,
                            tile_h=3, dw_act="relu", act="relu6")
    eye = jnp.eye(w["xm"].shape[-1], dtype=jnp.float32)
    # name -> (the wrapper, its inputs' keys, its output's c_out)
    cases = {}
    for coll in ("ring_allreduce", "psum_scatter"):
        cases["mbconv_retain_" + coll] = (
            lambda x, e, d, s1, b1, s2, b2, p, coll=coll: mb(
                x, e, d, s1, b1, s2, b2, p, collective=coll),
            ("x", "w_exp", "w_dw") + SE + ("w_proj",), 12)
        cases["fusedmb_" + coll] = (
            lambda x, c, p, coll=coll: fmb(x, c, p, collective=coll),
            ("x", "w_conv", "w_proj"), 12)
        cases["separable_in_" + coll] = (
            lambda x, d, p, coll=coll: sep(x, d, p, collective=coll,
                                           in_layout="model_sharded"),
            ("xm", "w_sdw", "w_pw"), 12)
    cases["mbconv_identity_in_psum_scatter"] = (
        lambda x, d, s1, b1, s2, b2, p: mb(
            x, eye, d, s1, b1, s2, b2, p, exp_act=None,
            collective="psum_scatter", in_layout="model_sharded"),
        ("xm", "w_dw") + SE + ("w_projm",), 16)
    cases["separable_replicated"] = (sep, ("xm", "w_sdw", "w_pw"), 12)
    b = {k: (v.astype(jnp.bfloat16) if k in sys.argv[3].split(",") else v)
         for k, v in w.items()}
    bf16 = ("mbconv_retain_psum_scatter", "fusedmb_ring_allreduce",
            "fusedmb_psum_scatter", "separable_in_ring_allreduce")
    out, grads = {}, {}
    for tag, arrays, names in (("", w, tuple(cases)), ("bf16_", b, bf16)):
        for name in names:
            fn, keys, c_out = cases[name]
            y, vjp = jax.vjp(fn, *(arrays[k] for k in keys))
            # the loss sum(out * r), r the port's seeded cotangent
            g = vjp(w["r_%d" % c_out].astype(y.dtype))
            out[tag + name] = np.asarray(y.astype(jnp.float32))
            for k, gk in zip(keys, g):
                grads[tag + name + "__" + k] = np.asarray(
                    gk.astype(jnp.float32))
    # the unsharded oracle's VJP at the bf16 operands, the gradient the
    # JAX wrappers' custom_vjp defines
    from repro.kernels.ref import separable_ref
    y, vjp = jax.vjp(lambda *a: separable_ref(*a, dw_act="relu",
                                              act="relu6"),
                     b["xm"], b["w_sdw"], b["w_pw"])
    for k, gk in zip(("xm", "w_sdw", "w_pw"),
                     vjp(w["r_12"].astype(y.dtype))):
        grads["bf16_oracle_separable_in_ring_allreduce__" + k] = np.asarray(
            gk.astype(jnp.float32))
    np.savez(sys.argv[2], **out)
    np.savez(sys.argv[4], **grads)
    # the sequence-parallel attention on RecurrentGemma SMOKE's heads: the
    # layer under the mesh (its route engages inside the jit) and the route
    # alone on q, k, v
    import dataclasses
    from repro.compat import activate_mesh
    from repro.configs.recurrentgemma_9b import SMOKE as RG
    from repro.models import attention as ja
    ap = {n: {"w": w["sa_" + n]} for n in "qkvo"}
    s = w["sa_x"].shape[1]
    sa = {}
    for name, kw in (("dense", {}), ("chunked", {"q_chunk": 4,
                                                 "kv_chunk": 3})):
        cfg = dataclasses.replace(RG, seq_shard_attn=True,
                                  **kw).attn_cfg(RG.window)
        engaged = []

        def layer(p, x, cfg=cfg, engaged=engaged):
            engaged.append(ja._seq_shard_mesh(cfg, x.shape[1]) is not None)
            return ja.attention(p, x, cfg)

        def route(q, k, v, cfg=cfg, chunked=bool(kw)):
            return ja._seq_parallel_sdpa(mesh, q, k, v, jnp.arange(s), cfg,
                                         RG.head_dim ** -0.5, chunked)

        try:
            with activate_mesh(mesh):
                sa[name] = np.asarray(jax.jit(layer)(ap, w["sa_x"]))
                sa["sdpa_" + name] = np.asarray(jax.jit(route)(
                    w["sq_q"], w["sq_k"], w["sq_v"]))
        except Exception as e:       # a fault of the reference, recorded
            sa["error_" + name] = np.asarray(f"{type(e).__name__}: {e}")
        sa["engaged_" + name] = np.asarray(engaged)
    # the expert-parallel MoE on Granite SMOKE's layer: its shard_map route
    # engages inside the jit under the mesh
    from repro.configs.granite_moe_3b_a800m import SMOKE as GR
    from repro.models import moe as jm
    mw = {n: w["moe_" + n] for n in ("router", "gate", "up", "down")}

    def moe_layer(p, x):
        return jm.moe_apply(p, x, GR.moe_cfg())

    with activate_mesh(mesh):
        sa["moe"] = np.asarray(jax.jit(moe_layer)(mw, w["moe_x"]))
        sa["moe_engaged"] = np.asarray(
            "shard_map" in str(jax.make_jaxpr(moe_layer)(mw, w["moe_x"])))
    np.savez(sys.argv[5], **sa)
""")


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX package's own sharded wrappers at mesh (2, 2) (4 virtual
    host devices, one subprocess): their outputs and their gradients
    (``jax.vjp``, ``residual_barrier`` at its default) of sum(out * r) at
    the port's cotangents; its sequence-parallel attention; and its
    expert-parallel MoE layer."""
    tmp = tmp_path_factory.mktemp("jax_sharded")
    np.savez(tmp / "in.npz", **_inputs(), **_seq_attn_inputs(),
             **_moe_inputs(),
             **{f"r_{c}": _cotangent(c) for c in (CO, CM)})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SHARDED, str(tmp / "in.npz"),
         str(tmp / "out.npz"), ",".join(BF16_WEIGHTS), str(tmp / "grad.npz"),
         str(tmp / "seq_attn.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return (np.load(tmp / "out.npz"), np.load(tmp / "grad.npz"),
            np.load(tmp / "seq_attn.npz"))


def test_wrappers_match_the_jax_sharded_wrappers(mesh_runs, jax_sharded):
    """The JAX package's own sharded wrappers at mesh (2, 2) (4 virtual
    host devices, one subprocess) on the same inputs; four of them on the
    bf16 operands too, at the bf16 bar and the JAX suite's absolute one
    (the Fused-MBConv ring and scatter exits among them: both sum bf16
    projection partials over "model")."""
    ref = jax_sharded[0]
    got = mesh_runs["2x2"]["wrappers"]
    got16 = mesh_runs["2x2"]["bf16_wrappers"]
    assert len(ref.files) == 12
    for name in ref.files:
        if name.startswith("bf16_"):
            print(_close_bf16(got16[name[5:]]["out"], ref[name], name,
                              absolute=True))
        else:
            np.testing.assert_allclose(got[name]["out"], ref[name],
                                       err_msg=name, **TOL)


# Faults of the reference at mesh (2, 2) (ROADMAP C): its separable
# wrapper with a replicated input returns w_dw's cotangent twice over
# (right at (1, 4) and (4, 1), the residual barrier on or not), and in bf16
# its sharded-in separable backward parts from its own oracle's VJP at the
# bf16 operands (relu / relu6 kinks on other sides at 28 elements of xm's
# gradient), which the port's equals; that case is held to the oracle.
JAX_DOUBLED = {"separable_replicated__w_sdw": 2.0}
JAX_BF16_PARTED = "bf16_separable_in_ring_allreduce"


def test_wrapper_grads_match_the_jax_sharded_wrappers(mesh_runs,
                                                      jax_sharded):
    """Every gradient the mesh (2, 2) took through a wrapper, against
    ``jax.grad`` through the JAX package's sharded wrapper on the same
    inputs and loss, within the JAX suite's gradient bar (rtol 2e-3, atol
    2e-3); the bf16 cases at the bf16 bar.  The identity expand's
    ``jnp.eye`` has no port twin (the port passes ``None``).  Where the
    reference is at fault (above), the fault itself is asserted, and the
    bf16 case is held to the reference's unsharded oracle instead (its
    sharded gradient reported, not gated)."""
    ref = jax_sharded[1]
    got = mesh_runs["2x2"]["grads"]
    got16 = mesh_runs["2x2"]["bf16_grads"]
    assert len(ref.files) == 58
    for key in ref.files:
        name, leaf = key.split("__")
        if name.startswith("bf16_oracle_"):
            print(_close_bf16(got16[name[12:]]["grads"][leaf], ref[key],
                              key))
        elif name == JAX_BF16_PARTED:
            print(_bf16_report(got16[name[5:]]["grads"][leaf], ref[key],
                               key + " (not gated)")[0])
        elif name.startswith("bf16_"):
            print(_close_bf16(got16[name[5:]]["grads"][leaf], ref[key], key,
                              absolute=True))
        else:
            np.testing.assert_allclose(
                JAX_DOUBLED.get(key, 1.0) * got[name]["grads"][leaf],
                ref[key], err_msg=key, **GRAD_TOL)


def test_network_forwards_match_jax(mesh_runs, port_refs):
    """The mesh forwards against the JAX package's unsharded networks at the
    same weights (the port's seeded tree carried into JAX); B0 in bf16 at
    the bf16 bar."""
    import jax
    import jax.numpy as jnp
    from repro.models import mbconv as jm

    nets = port_refs[1]
    jcfgs = {"b0": jm.EffNetConfig(width_mult=0.125, num_classes=4),
             "b0_bf16": jm.EffNetConfig(width_mult=0.125, num_classes=4,
                                        dtype="bfloat16"),
             "v3": jm.MobileNetV3Config(num_classes=4, width_mult=0.125),
             "v2s": jm.EffNetV2Config(
                 num_classes=4, width_mult=0.25, head_c=128,
                 stages=NETS["v2s"][0].stages)}
    japply = {"b0": jm.efficientnet_b0_apply, "v3": jm.mobilenet_v3_apply,
              "v2s": jm.efficientnet_v2_s_apply,
              "b0_bf16": jm.efficientnet_b0_apply}
    for net, (params, images, _, _) in nets.items():
        jparams = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                               params)
        ref = np.asarray(japply[net](jparams, jnp.asarray(images.numpy()),
                                     jcfgs[net]).astype(jnp.float32))
        for mesh in MESHES:
            got = mesh_runs[mesh]["networks"][net]["logits"]
            if net in NETS:
                np.testing.assert_allclose(got, ref, err_msg=f"{mesh} {net}",
                                           **TOL)
            else:
                print(_close_bf16(got, ref, f"{mesh} {net}"))


# ---------------------------------------------------------------------------
# sequence-parallel attention
# ---------------------------------------------------------------------------

SA_TOL = 1e-5                    # x max|ref|, + 1e-6


def _sa_close(got, want, err_msg=""):
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, err_msg
    assert err <= SA_TOL * float(np.abs(want).max()) + 1e-6, (err_msg, err)


@pytest.fixture(scope="module")
def seq_attn_refs():
    """Each sequence-parallel case computed unsharded on this process."""
    w = _seq_attn_inputs()
    params = _seq_attn_params(w)
    x = torch.from_numpy(w["sa_x"])
    q, k, v = (torch.from_numpy(w["sq_" + n]) for n in "qkv")
    refs = {}
    for name, kw in SA_CASES.items():
        cfg = _seq_attn_cfg(**kw)
        refs[name] = ta.attention(params, x, cfg).numpy()
        pos = torch.arange(SA_S)
        if kw:
            out = ta._chunked_sdpa(q, k, v, pos, pos, True, cfg.window,
                                   RG_SMOKE.head_dim ** -0.5, 0.0,
                                   cfg.q_chunk, cfg.kv_chunk)
        else:
            out = ta._sdpa(q, k, v, ta._mask_bias(pos, pos, True, cfg.window),
                           RG_SMOKE.head_dim ** -0.5, 0.0)
        refs["sdpa_" + name] = out.numpy()
    refs["off"] = refs["dense"]
    p2 = dict(params, k={"w": params["k"]["w"].repeat(1, 2)},
              v={"w": params["v"]["w"].repeat(1, 2)})
    refs["kv2"] = ta.attention(p2, x, _seq_attn_cfg(n_kv_heads=2)).numpy()
    return refs


@pytest.mark.parametrize("mesh", list(MESHES))
def test_seq_parallel_attention_matches_unsharded(mesh_runs, seq_attn_refs,
                                                  mesh):
    """RecurrentGemma ``SMOKE``'s attention (one KV head, window 8) with
    ``seq_shard`` on a mesh equals the unsharded layer, dense and chunked
    (q_chunk 4 under the local length 8), and so does the route alone.
    Where the model axis has 2 ranks (1x2, 2x2, 2x1x2) each case takes
    one all-gather of its rows over "model"; at (2, 1) the route does not
    engage, and neither does it with ``seq_shard`` off or with two KV
    heads, which the model axis divides: no model-axis collective."""
    got = mesh_runs[mesh]["seq_attn"]
    mp = MESHES[mesh][0][-1]
    assert set(got) == set(seq_attn_refs)
    for name, ref in seq_attn_refs.items():
        _sa_close(got[name]["out"], ref, f"{mesh} {name}")
        model = {k: v for k, v in got[name]["counts"].items()
                 if ".model" in k}
        engages = mp > 1 and name not in ("off", "kv2")
        # the gathered output: this rank's batch slice, every row and head
        dp = math.prod(MESHES[mesh][0]) // mp
        words = SA_B // dp * SA_S * RG_SMOKE.n_heads * RG_SMOKE.head_dim
        want = {"all_gather.model": (1, words)} if engages else {}
        assert model == want, (mesh, name, model)


def test_seq_parallel_attention_without_a_mesh_is_a_noop():
    """Without a mesh ``seq_shard`` changes nothing, in the layer and in
    the whole model: bit for bit the output with it off, as in JAX."""
    w = _seq_attn_inputs()
    params = _seq_attn_params(w)
    x = torch.from_numpy(w["sa_x"])
    on = ta.attention(params, x, _seq_attn_cfg())
    off = ta.attention(params, x, _seq_attn_cfg()._replace(seq_shard=False))
    assert torch.equal(on, off)
    from repro_torch.models import model as lm
    cfg = dataclasses.replace(RG_SMOKE, seq_shard_attn=True)
    params = materialize(lm.model_def(cfg), torch.Generator().manual_seed(4),
                         "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 12)))
    assert torch.equal(
        lm.forward(params, {"tokens": tokens}, cfg),
        lm.forward(params, {"tokens": tokens}, RG_SMOKE))


def test_seq_parallel_attention_matches_jax(mesh_runs, jax_sharded):
    """At mesh (2, 2) the port's route and layer equal the JAX package's:
    its ``attention`` jitted under the mesh, where ``_seq_shard_mesh``
    engaged, and its ``_seq_parallel_sdpa`` alone, within 1e-5 of
    max|JAX|.  The JAX chunked route does not trace inside its
    ``shard_map`` (its online softmax's ``lax.scan`` starts from a carry
    that is not varying over the mesh; ROADMAP C), so that case is held
    to the unsharded layer only and the reference's error is asserted."""
    ref = jax_sharded[2]
    got = mesh_runs["2x2"]["seq_attn"]
    assert ref["engaged_dense"].tolist() == [True]
    for key in ("dense", "sdpa_dense"):
        _sa_close(got[key]["out"], ref[key], key)
    assert "error_dense" not in ref.files
    assert "scan" in str(ref["error_chunked"]) and "chunked" not in ref.files


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------

def _moe_close(got, want, err_msg=""):
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, err_msg
    assert err <= MOE_TOL * float(np.abs(want).max()) + 1e-6, (err_msg, err)


@pytest.fixture(scope="module")
def moe_refs():
    """dp -> the unsharded layer on each of dp batch slices (its capacity
    that slice's, as each rank's): the output, the pairs each slice
    dropped, and the gradients of sum(out * r)."""
    w = _moe_inputs()
    refs = {}
    for dp in (1, 2):
        params = {n: torch.from_numpy(w["moe_" + n]).requires_grad_()
                  for n in MOE_KEYS}
        x = torch.from_numpy(w["moe_x"]).clone().requires_grad_()
        with tmoe.recording() as drops:
            out = torch.cat([tmoe.moe_apply(params, xs, MOE_CFG)
                             for xs in x.chunk(dp)])
        (out * torch.from_numpy(w["moe_r"])).sum().backward()
        refs[dp] = dict(out=out.detach().numpy(),
                        dropped=[int(d.dropped) for d in drops],
                        x_grad=x.grad.numpy(),
                        grads={n: params[n].grad.numpy() for n in MOE_KEYS})
    return refs


@pytest.mark.parametrize("mesh", list(MESHES) + ["1x4"])
def test_expert_parallel_moe_matches_unsharded(mesh_runs, moe_refs, mesh):
    """Granite ``SMOKE``'s MoE layer at the default capacity on each mesh
    (and, in the (2, 2) spawn's four ranks, at (1, 4)) equals the
    unsharded layer on the same batch slices, drops included: its output
    and the gradients of sum(out * r).  Where the model axis has M > 1
    ranks (each holding 8 / M experts) the forward takes one all-reduce of
    the slice's output over "model"; the backward sums x's and the
    router's cotangents over "model" and gathers the experts' gradient
    chunks; on a model axis of 1 the layer runs locally, no model-axis
    collective."""
    got = (mesh_runs["2x2"]["moe_1x4"] if mesh == "1x4"
           else mesh_runs[mesh]["moe"])
    shape = (1, 4) if mesh == "1x4" else MESHES[mesh][0]
    mp = shape[-1]
    dp = math.prod(shape) // mp
    ref = moe_refs[dp]
    _moe_close(got["out"], ref["out"], f"{mesh} out")
    _moe_close(got["x_grad"], ref["x_grad"], f"{mesh} x grad")
    for n in MOE_KEYS:
        _moe_close(got["grads"][n], ref["grads"][n], f"{mesh} {n} grad")
    # rank 0 holds the first batch slice, which drops pairs
    assert got["dropped"] == ref["dropped"][:1] and got["dropped"][0] > 0
    d, f, e = MOE_CFG.d_model, MOE_CFG.d_ff, MOE_CFG.n_experts_pad
    tokens = MOE_B // dp * MOE_S
    model = {k: v for k, v in got["counts"].items() if ".model" in k}
    assert model == ({"all_reduce.model": (1, tokens * d)} if mp > 1
                     else {}), (mesh, model)
    back = {k: v for k, v in got["backward_counts"].items()
            if ".model" in k}
    want = {"all_reduce.model.backward": (2, tokens * d + d * e),
            "all_gather.model.backward": (3, 3 * e * d * f)} if mp > 1 \
        else {}
    assert back == want, (mesh, back)


def test_expert_parallel_moe_matches_jax(mesh_runs, jax_sharded):
    """At mesh (2, 2) the port's expert-parallel layer equals the JAX
    package's ``shard_map`` route (it engaged under the mesh) on the same
    inputs, its capacity each data shard's tokens."""
    ref = jax_sharded[2]
    assert bool(ref["moe_engaged"])
    _moe_close(mesh_runs["2x2"]["moe"]["out"], ref["moe"], "2x2 vs JAX")

"""The sharded ConvDK wrappers and the network forwards on a mesh of CPU
ranks (gloo over ``torch.distributed``), against the port's single-device
ops and forwards, the JAX package's unsharded ops and networks at the same
seed, and its own sharded wrappers at mesh (2, 2).

Every case of one mesh shape runs in one spawn of ranks
(``_rank_cases``, which imports no JAX): the three wrappers with ring and
scatter exits, the sharded-in entries, a scatter that pads an indivisible
c_out, two chained blocks whose layouts match, and a small B0, V3 and V2-S
forward, each with the collectives it counted; then the bf16 cases: the
wrappers' ring and scatter exits and sharded-in entries on bf16 operands
and B0 with ``dtype="bfloat16"``.  Rank 0 saves the global outputs; the
tests compare them here within the JAX suite's sharded bar (rtol 1e-4,
atol 1e-4; bf16: its bf16 bar, 2e-2, the absolute part at the output's
scale), and the counted collectives with the model's.
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

from repro_torch.configs.efficientnet_b0 import efficientnet_b0_smoke
from repro_torch.configs.efficientnet_v2_s import efficientnet_v2_s_smoke
from repro_torch.configs.mobilenet_v3_large import mobilenet_v3_large_smoke
from repro_torch.core import perfmodel as tp
from repro_torch.kernels import convdk_sharded as S
from repro_torch.kernels.convdk_fused import convdk_fused_separable
from repro_torch.kernels.convdk_fusedmb import convdk_fusedmb_fused
from repro_torch.kernels.convdk_mbconv import convdk_mbconv_fused
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import mbconv as tm
from repro_torch.models.param import materialize

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_RTOL = 2e-2                          # tests/test_kernels.py's bf16 bar


def _close_bf16(got, ref, err_msg=""):
    """Within the bf16 bar: rtol 2e-2, and atol 2e-2 x max|ref|.  A mesh
    sums its ranks' bf16-rounded partials (as the JAX package's psum
    does), whose rounding scales with the partials, not with each output
    element, so the absolute part is taken at the output's scale."""
    np.testing.assert_allclose(
        got, ref, rtol=BF16_RTOL,
        atol=BF16_RTOL * float(np.abs(ref).max()), err_msg=err_msg)


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
        for name, (cfg, def_fn, apply) in _net_runs():
            params = materialize(def_fn(cfg), torch.Generator().manual_seed(3),
                                 device="cpu")
            images = torch.from_numpy(np.random.default_rng(5).random(
                (NET_BATCH, NET_SIDE, NET_SIDE, 3), np.float32))
            plan = tm.network_plan(tm_specs(name.split("_")[0], cfg),
                                   NET_BATCH, NET_SIDE, NET_SIDE,
                                   S.conv_mesh_shape(mesh),
                                   tm.dtype_bytes(cfg.dtype))
            mesh.reset_counts()
            logits = apply(params, images, cfg, mesh=mesh)
            model_counts = {k: v for k, v in _counts(mesh).items()
                            if k.endswith(".model")}
            res["networks"][name] = dict(
                logits=logits.float().numpy(), dtype=str(logits.dtype),
                counts=model_counts,
                wire_words=dp * mesh.model_wire_words(),
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


@pytest.fixture(scope="module")
def port_refs():
    """The single-device results of every wrapper case and network."""
    w = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    ref = {}

    def mb(x, w_exp, w_proj, mode="retain", se_on=True, **acts):
        s = ((w["w_se1"], w["b_se1"], w["w_se2"], w["b_se2"]) if se_on
             else (None,) * 4)
        return convdk_mbconv_fused(x, w_exp, w["w_dw"], *s, w_proj,
                                   tile_h=3, tile_w=4, mode=mode, **acts)

    for coll in ("ring_allreduce", "psum_scatter"):
        for mode in ("retain", "recompute"):
            ref[f"mbconv_{mode}_{coll}"] = mb(w["x"], w["w_exp"],
                                              w["w_proj"], mode)
        ref[f"mbconv_identity_in_{coll}"] = mb(w["xm"], None, w["w_projm"],
                                               exp_act=None)
        ref[f"fusedmb_{coll}"] = convdk_fusedmb_fused(
            w["x"], w["w_conv"], w["w_proj"], tile_h=3, tile_w=4)
        ref[f"separable_in_{coll}"] = convdk_fused_separable(
            w["xm"], w["w_sdw"], w["w_pw"], tile_h=3, tile_w=4,
            dw_act="relu", act="relu6")
    ref["mbconv_v3_no_se_recompute"] = mb(
        w["x"], w["w_exp"], w["w_proj"], "recompute", se_on=False,
        exp_act="hard_swish", dw_act="hard_swish")
    ref["mbconv_v3_se_gate"] = mb(w["x"], w["w_exp"], w["w_proj"],
                                  exp_act="relu", dw_act="relu",
                                  se_act="relu", gate_act="hard_sigmoid")
    ref["mbconv_expand_in"] = mb(w["x"], w["w_exp"], w["w_proj"])
    ref["mbconv_pad_scatter"] = mb(w["x"], w["w_exp"], w["w_proj9"])
    ref["fusedmb_pad_scatter"] = convdk_fusedmb_fused(
        w["x"], w["w_conv"], w["w_proj9"], tile_h=3, tile_w=4)
    ref["separable_replicated"] = ref["separable_in_ring_allreduce"]
    ref["chain_scatter_into_identity"] = mb(
        mb(w["x"], w["w_exp"], w["w_projm"]), None, w["w_projm"],
        exp_act=None)
    nets = {}
    for name, (cfg, def_fn, apply) in _net_runs():
        params = materialize(def_fn(cfg), torch.Generator().manual_seed(3),
                             device="cpu")
        images = torch.from_numpy(np.random.default_rng(5).random(
            (NET_BATCH, NET_SIDE, NET_SIDE, 3), np.float32))
        nets[name] = (params, images, apply(params, images, cfg))
    return {k: v.numpy() for k, v in ref.items()}, nets


@pytest.fixture(scope="module")
def port_refs_bf16():
    """The single-device results of the bf16 wrapper cases, on the same
    bf16 operands (fp32 arrays of the bf16 outputs)."""
    w = _bf16_inputs(_inputs())
    se = (w["w_se1"], w["b_se1"], w["w_se2"], w["b_se2"])

    def mb(x, w_exp, w_proj, mode="retain", **acts):
        return convdk_mbconv_fused(x, w_exp, w["w_dw"], *se, w_proj,
                                   tile_h=3, tile_w=4, mode=mode, **acts)

    sep = convdk_fused_separable(w["xm"], w["w_sdw"], w["w_pw"], tile_h=3,
                                 tile_w=4, dw_act="relu", act="relu6")
    ref = {"mbconv_retain_ring_allreduce": mb(w["x"], w["w_exp"],
                                              w["w_proj"]),
           "mbconv_recompute_ring_allreduce": mb(w["x"], w["w_exp"],
                                                 w["w_proj"], "recompute"),
           "mbconv_identity_in_psum_scatter": mb(w["xm"], None,
                                                 w["w_projm"], exp_act=None),
           "fusedmb_ring_allreduce": convdk_fusedmb_fused(
               w["x"], w["w_conv"], w["w_proj"], tile_h=3, tile_w=4),
           "separable_in_ring_allreduce": sep, "separable_replicated": sep}
    ref["mbconv_retain_psum_scatter"] = ref["mbconv_retain_ring_allreduce"]
    ref["fusedmb_psum_scatter"] = ref["fusedmb_ring_allreduce"]
    ref["separable_in_psum_scatter"] = sep
    assert all(v.dtype == torch.bfloat16 for v in ref.values())
    return {k: v.float().numpy() for k, v in ref.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_wrappers_match_single_device(mesh_runs, port_refs, mesh):
    """The three wrappers, ring and scatter exits, the sharded-in entries
    (identity free, a real expand gathered), the padded scatters and the
    chained pair, gathered to their global form, equal the single-device
    ops within the sharded bar."""
    refs, _ = port_refs
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
    _, nets = port_refs
    r = mesh_runs[mesh]["networks"][net]
    ref = nets[net][2]
    assert r["dtype"] == str(ref.dtype)
    if net in NETS:
        np.testing.assert_allclose(r["logits"], ref.numpy(), **TOL)
    else:
        _close_bf16(r["logits"], ref.float().numpy())
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
        _close_bf16(r["out"], port_refs_bf16[name], name)
        assert r["wire_words"] == r["model_words"], name


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
    divide, a sharded input to Fused-MBConv, a batch the data factor does
    not divide, and a gradient all raise before any collective."""
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
    with pytest.raises(NotImplementedError, match="backward"):
        S.convdk_fusedmb_fused_sharded(
            x, torch.zeros(3, 3, 8, 16, requires_grad=True),
            torch.zeros(16, 8), mesh=mesh)
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
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.kernels import (convdk_fused_separable_sharded,
                               convdk_fusedmb_fused_sharded,
                               convdk_mbconv_fused_sharded)
    w = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
    mesh = make_mesh((2, 2), ("data", "model"))
    se = (w["w_se1"], w["b_se1"], w["w_se2"], w["b_se2"])
    out = {}
    for coll in ("ring_allreduce", "psum_scatter"):
        out["mbconv_retain_" + coll] = convdk_mbconv_fused_sharded(
            w["x"], w["w_exp"], w["w_dw"], *se, w["w_proj"], mesh=mesh,
            tile_h=3, collective=coll)
        out["fusedmb_" + coll] = convdk_fusedmb_fused_sharded(
            w["x"], w["w_conv"], w["w_proj"], mesh=mesh, tile_h=3,
            collective=coll)
        out["separable_in_" + coll] = convdk_fused_separable_sharded(
            w["xm"], w["w_sdw"], w["w_pw"], mesh=mesh, tile_h=3,
            dw_act="relu", act="relu6", collective=coll,
            in_layout="model_sharded")
    out["mbconv_identity_in_psum_scatter"] = convdk_mbconv_fused_sharded(
        w["xm"], jnp.eye(w["xm"].shape[-1], dtype=jnp.float32), w["w_dw"],
        *se, w["w_projm"], mesh=mesh, tile_h=3, exp_act=None,
        collective="psum_scatter", in_layout="model_sharded")
    out["separable_replicated"] = convdk_fused_separable_sharded(
        w["xm"], w["w_sdw"], w["w_pw"], mesh=mesh, tile_h=3, dw_act="relu",
        act="relu6")
    b = {k: (v.astype(jnp.bfloat16) if k in sys.argv[3].split(",") else v)
         for k, v in w.items()}
    se16 = (b["w_se1"], b["b_se1"], b["w_se2"], b["b_se2"])
    bf16 = {
        "mbconv_retain_psum_scatter": convdk_mbconv_fused_sharded(
            b["x"], b["w_exp"], b["w_dw"], *se16, b["w_proj"], mesh=mesh,
            tile_h=3, collective="psum_scatter"),
        "fusedmb_ring_allreduce": convdk_fusedmb_fused_sharded(
            b["x"], b["w_conv"], b["w_proj"], mesh=mesh, tile_h=3),
        "separable_in_ring_allreduce": convdk_fused_separable_sharded(
            b["xm"], b["w_sdw"], b["w_pw"], mesh=mesh, tile_h=3,
            dw_act="relu", act="relu6", in_layout="model_sharded"),
    }
    out.update({"bf16_" + k: np.asarray(v.astype(jnp.float32))
                for k, v in bf16.items()})
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""")


def test_wrappers_match_the_jax_sharded_wrappers(mesh_runs, tmp_path):
    """The JAX package's own sharded wrappers at mesh (2, 2) (4 virtual
    host devices, one subprocess) on the same inputs; three of them on the
    bf16 operands too, at the bf16 bar."""
    np.savez(tmp_path / "in.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SHARDED, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz"), ",".join(BF16_WEIGHTS)], env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    ref = np.load(tmp_path / "out.npz")
    got = mesh_runs["2x2"]["wrappers"]
    got16 = mesh_runs["2x2"]["bf16_wrappers"]
    assert len(ref.files) == 11
    for name in ref.files:
        if name.startswith("bf16_"):
            _close_bf16(got16[name[5:]]["out"], ref[name], name)
        else:
            np.testing.assert_allclose(got[name]["out"], ref[name],
                                       err_msg=name, **TOL)


def test_network_forwards_match_jax(mesh_runs, port_refs):
    """The mesh forwards against the JAX package's unsharded networks at the
    same weights (the port's seeded tree carried into JAX); B0 in bf16 at
    the bf16 bar."""
    import jax
    import jax.numpy as jnp
    from repro.models import mbconv as jm

    _, nets = port_refs
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
    for net, (params, images, _) in nets.items():
        jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
        ref = np.asarray(japply[net](jparams, jnp.asarray(images.numpy()),
                                     jcfgs[net]).astype(jnp.float32))
        for mesh in MESHES:
            got = mesh_runs[mesh]["networks"][net]["logits"]
            if net in NETS:
                np.testing.assert_allclose(got, ref, err_msg=f"{mesh} {net}",
                                           **TOL)
            else:
                _close_bf16(got, ref, f"{mesh} {net}")

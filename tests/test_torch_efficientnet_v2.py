"""EfficientNet-V2-S and MobileNet-V3-Large in the port against the JAX
package: the JAX param tree carried over through ``from_numpy`` gives the
same logits, the port declares the same parameters at full width, the
block-graph contract holds for mixed chains, and B0's chain lowered
through the block graph is its forward's block loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mbconv as jm
from repro.models.param import materialize as jax_materialize
from repro_torch.configs.efficientnet_v2_s import (
    efficientnet_v2_s,
    efficientnet_v2_s_smoke,
)
from repro_torch.configs.mobilenet_v3_large import (
    mobilenet_v3_large,
    mobilenet_v3_large_smoke,
)
from repro_torch.models import mbconv as tm
from repro_torch.models.blockgraph import (
    BlockGraph,
    BlockNode,
    GraphValidationError,
    StageIO,
    build_block_graph,
    fusedmb_stage_io,
    mbconv_stage_io,
)
from repro_torch.models.param import from_numpy, materialize

TOL = 1e-4   # the JAX suite's fp32 bar, taken relative to the logits' scale

# the truncated V2-S of the JAX package's own end-to-end test
# (tests/test_families.py): fused head + MBConv tail at 1/4 width
JAX_V2S = jm.EffNetV2Config(num_classes=4, width_mult=0.25, head_c=128,
                            stages=(("fusedmb", 1, 3, 1, 24, 1),
                                    ("fusedmb", 4, 3, 2, 48, 2),
                                    ("mbconv", 4, 3, 2, 64, 2)))
JAX_V3 = jm.MobileNetV3Config(num_classes=4, width_mult=0.125)


def _shapes(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_shapes(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(tree[k].shape)
    return out


@pytest.fixture(scope="module")
def v2s():
    jparams = jax_materialize(jm.efficientnet_v2_s_def(JAX_V2S),
                              jax.random.key(1))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams, efficientnet_v2_s_smoke()


@pytest.fixture(scope="module")
def v3():
    jparams = jax_materialize(jm.mobilenet_v3_def(JAX_V3), jax.random.key(0))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams, mobilenet_v3_large_smoke()


def _rel_err(port: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(port.numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("side", [16, 23])
def test_v2s_logits_match_jax_through_weight_bridge(v2s, side):
    jparams, tparams, tcfg = v2s
    images = np.random.default_rng(side).random((2, side, side, 3),
                                                np.float32)
    ref = jm.efficientnet_v2_s_apply(jparams, jnp.asarray(images), JAX_V2S)
    port = tm.efficientnet_v2_s_apply(tparams, torch.from_numpy(images),
                                      tcfg)
    assert port.shape == (2, 4)
    assert _rel_err(port, ref) <= TOL


def test_v2s_specs_and_full_width_params_equal_jax():
    """Full-width V2-S: the same 40-block table (10 fused) and the same
    param keys and shapes, from the P trees alone."""
    jspecs = jm.effnet_v2_block_specs(jm.EffNetV2Config())
    tspecs = tm.effnet_v2_block_specs(efficientnet_v2_s())
    assert [(s.family, s.c_in, s.c_mid, s.c_out, s.k, s.s, s.has_se,
             s.c_se, s.act) for s in tspecs] == \
        [(s.family, s.c_in, s.c_mid, s.c_out, s.k, s.s, s.has_se, s.c_se,
          s.act) for s in jspecs]
    assert sum(s.family == "fusedmb" for s in tspecs) == 10
    assert _shapes(tm.efficientnet_v2_s_def(efficientnet_v2_s())) == \
        _shapes(jm.efficientnet_v2_s_def(jm.EffNetV2Config()))


def test_v2s_module_forward_equals_apply(v2s):
    _, tparams, tcfg = v2s
    model = tm.EfficientNetV2S(tcfg, params=tparams, device="cpu")
    images = torch.rand(2, 20, 20, 3,
                        generator=torch.Generator().manual_seed(1))
    assert torch.equal(model(images),
                       tm.efficientnet_v2_s_apply(tparams, images, tcfg))
    mine = materialize(tm.efficientnet_v2_s_def(tcfg),
                       torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(mine) == _shapes(tparams)


def test_v3_logits_match_jax_through_weight_bridge(v3):
    jparams, tparams, tcfg = v3
    images = np.random.default_rng(5).random((2, 16, 16, 3), np.float32)
    ref = jm.mobilenet_v3_apply(jparams, jnp.asarray(images), JAX_V3)
    port = tm.mobilenet_v3_apply(tparams, torch.from_numpy(images), tcfg)
    assert port.shape == (2, 4)
    assert _rel_err(port, ref) <= TOL


def test_v3_specs_and_full_width_params_equal_jax():
    """Full-width V3-Large: per-block act, SE placement and flavour,
    pinned c_mid, and the same param keys and shapes."""
    jspecs = jm.mobilenet_v3_specs(jm.MobileNetV3Config())
    tspecs = tm.mobilenet_v3_specs(mobilenet_v3_large())
    fields = ("c_in", "c_mid", "c_out", "k", "s", "has_se", "c_se", "act",
              "se_act", "gate_act", "family")
    assert [tuple(getattr(s, f) for f in fields) for s in tspecs] == \
        [tuple(getattr(s, f) for f in fields) for s in jspecs]
    assert sum(s.has_se for s in tspecs) == 8
    assert _shapes(tm.mobilenet_v3_def(mobilenet_v3_large())) == \
        _shapes(jm.mobilenet_v3_def(jm.MobileNetV3Config()))


def test_fusedmb_nodes_are_one_pass_and_validate(v2s):
    """Mirror of the JAX graph contract: fusedmb nodes carry an empty
    pass 2 and validate; the mixed V2-S chain validates; an ill-formed
    chain is refused."""
    _, tparams, tcfg = v2s
    p1, p2 = fusedmb_stage_io(3)
    assert "act3" in p1.reads and "act4" in p1.writes
    assert not p2.reads and not p2.writes

    graph = build_block_graph(tm.effnet_v2_block_specs(tcfg), tparams)
    graph.validate()
    assert [n.one_pass for n in graph.nodes] == [True, True, True, False,
                                                 False]

    p1b, p2b = mbconv_stage_io(1, mode="recompute", se=False)
    assert p1b.writes == frozenset() and "act1" in p2b.reads
    bad = BlockGraph(nodes=(
        BlockNode(0, "fusedmb0", *fusedmb_stage_io(0)),
        BlockNode(1, "mbconv1", p1b, StageIO.of({"act1"}, {"act3"}))))
    with pytest.raises(GraphValidationError, match="exit activation"):
        bad.validate()
    with pytest.raises(GraphValidationError, match="index"):
        BlockGraph(nodes=(BlockNode(1, "m", p1b, p2b),)).validate()
    with pytest.raises(GraphValidationError, match="apply"):
        BlockGraph(nodes=(BlockNode(0, "f", *fusedmb_stage_io(0)),)) \
            .lower(torch.zeros(1))


@pytest.mark.parametrize("mode", [None, "recompute"])
def test_b0_unchanged_on_the_block_graph(mode):
    """B0's forward, the plain block loop, and its chain lowered through
    ``build_block_graph`` give the same logits bit for bit."""
    cfg = tm.EffNetConfig(width_mult=0.25, num_classes=10)
    params = materialize(tm.efficientnet_b0_def(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    images = torch.rand(2, 37, 41, 3,
                        generator=torch.Generator().manual_seed(1))
    stem = torch.nn.functional.silu(tm.stem_conv(images, params["stem"]))
    specs = tm.effnet_block_specs(cfg)
    x = stem
    for i, sp in enumerate(specs):
        x = tm.mbconv_block(x, params[f"block{i}"], stride=sp.s, mode=mode)
    graph = build_block_graph(specs, params, mode=mode)
    graph.validate()
    x_graph = graph.lower(stem)

    def head(x):
        x = torch.nn.functional.silu(x @ params["head"]).mean(dim=(1, 2))
        return x @ params["cls_w"] + params["cls_b"]

    logits = tm.efficientnet_b0_apply(params, images, cfg, mode=mode)
    assert torch.equal(logits, head(x))
    assert torch.equal(logits, head(x_graph))

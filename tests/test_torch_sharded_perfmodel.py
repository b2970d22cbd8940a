"""The mesh half of the port's byte model (``repro_torch.core.perfmodel``)
equals the JAX package's exactly: every sharded traffic, collective word,
layout transition and per-pass split over a grid of block shapes, modes,
layouts, collectives and meshes (a pod mesh priced at its folded factors),
at the strip-staged residency the port fixes."""

from __future__ import annotations

import itertools
import types

import pytest

import repro.core.perfmodel as J
import repro.kernels.convdk_sharded as JS
import repro_torch.core.perfmodel as T
import repro_torch.kernels.convdk_sharded as TS

MESHES = [(1, 1), (2, 1), (1, 2), (2, 4), (8, 1)]
# (b, hw, c_in, c_mid, c_out, k, s, se_ratio): SE and not, identity and
# real expands, a c_out no factor divides, stride 2
BLOCKS = [(8, 14, 80, 480, 112, 5, 1, 0.25), (8, 28, 32, 32, 16, 3, 1, 0.25),
          (8, 9, 16, 16, 16, 3, 2, 0.0), (4, 7, 24, 144, 40, 5, 2, 0.25),
          (8, 12, 40, 200, 114, 3, 1, 0.0), (6, 10, 24, 72, 24, 3, 1, 0.25)]
TILES = (1, 4, 8)
C_BLOCKS = (32, 128)


def _fields(t):
    """Every number a traffic object carries, nested."""
    if isinstance(t, (J.ShardedTraffic, T.ShardedTraffic)):
        return (_fields(t.device), t.collective_words, t.n_devices,
                tuple(t.mesh_shape), t.collective, t.in_layout,
                t.transition_words, t.total_bytes, t.per_device_bytes,
                t.collective_bytes, t.transition_bytes, t.out_layout)
    if isinstance(t, (J.MBConvPassCosts, T.MBConvPassCosts)):
        return (_fields(t.pass1), _fields(t.pass2), t.pass1_collective_words,
                t.pass2_collective_words, t.pass1_collective_bytes,
                t.pass2_collective_bytes)
    return (t.read_words, t.write_words, t.dtype_bytes, t.dma_issues)


def _shapes(block):
    b, hw, ci, cm, co, k, s, se = block
    kw = dict(b=b, h=hw, w=hw, c_in=ci, c_mid=cm, c_out=co, k=k, s=s,
              se_ratio=se)
    return J.MBConvShape(**kw), T.MBConvShape(**kw)


def test_constants_match():
    assert T.COLLECTIVE_MODES == J.COLLECTIVE_MODES
    assert T.LAYOUT_MODES == J.LAYOUT_MODES
    assert T.OVERLAP_MODES == J.OVERLAP_MODES
    assert (T.DEFAULT_COLLECTIVE, T.DEFAULT_LAYOUT, T.DEFAULT_OVERLAP) == \
        (J.DEFAULT_COLLECTIVE, J.DEFAULT_LAYOUT, J.DEFAULT_OVERLAP)
    for bad in ("ring", "sharded"):
        for fn in ("validate_collective", "validate_layout",
                   "validate_overlap"):
            with pytest.raises(ValueError):
                getattr(T, fn)(bad)


@pytest.mark.parametrize("mesh", MESHES)
def test_mbconv_mesh_pricing_equals_jax(mesh):
    for block in BLOCKS:
        js, ts = _shapes(block)
        assert T.shard_factors(ts.b, ts.c_mid, mesh) == \
            J.shard_factors(js.b, js.c_mid, mesh)
        assert T.can_shard_input(ts, mesh) == J.can_shard_input(js, mesh)
        assert T.can_psum_scatter(ts, mesh) == J.can_psum_scatter(js, mesh)
        for lay in T.LAYOUT_MODES:
            jl, je = J.mbconv_shard(js, mesh, lay)
            tl, te = T.mbconv_shard(ts, mesh, lay)
            assert (vars(tl), te) == (vars(jl), je)
            for th, cb, coll in itertools.product(TILES, C_BLOCKS,
                                                  T.COLLECTIVE_MODES):
                for mode in T.MBCONV_MODES:
                    assert _fields(T.sharded_mbconv_traffic(
                        ts, th, mode, mesh, cb, coll, lay)) == _fields(
                        J.sharded_mbconv_traffic(
                            js, th, mode, mesh, cb, collective=coll,
                            in_layout=lay))
                    assert _fields(T.sharded_mbconv_pass_costs(
                        ts, th, mode, mesh, cb, coll, lay)) == _fields(
                        J.sharded_mbconv_pass_costs(
                            js, th, mode, mesh, cb, collective=coll,
                            in_layout=lay))
                assert _fields(T.sharded_mbconv_staged_traffic(
                    ts, th, mesh, cb, coll, lay)) == _fields(
                    J.sharded_mbconv_staged_traffic(js, th, mesh, cb, coll,
                                                    lay))
                dp, mp = T.shard_factors(ts.b, ts.c_mid, mesh)
                assert T._mbconv_collective_split(ts, dp, mp, coll) == \
                    J._mbconv_collective_split(js, dp, mp, coll)
                assert T._mbconv_collective_words(ts, dp, mp, coll) == \
                    J._mbconv_collective_words(js, dp, mp, coll)
                assert T._mbconv_entry_transition_words(ts, dp, mp, lay) == \
                    J._mbconv_entry_transition_words(js, dp, mp, lay)


@pytest.mark.parametrize("mesh", MESHES)
def test_fusedmb_mesh_pricing_equals_jax(mesh):
    for block in BLOCKS:
        js, ts = _shapes(block[:-1] + (0.0,))
        jl, je = J.fusedmb_shard(js, mesh)
        tl, te = T.fusedmb_shard(ts, mesh)
        assert (vars(tl), te) == (vars(jl), je)
        for th, cb, coll in itertools.product(TILES, C_BLOCKS,
                                              T.COLLECTIVE_MODES):
            assert _fields(T.sharded_fusedmb_traffic(
                ts, th, mesh, cb, coll)) == _fields(
                J.sharded_fusedmb_traffic(js, th, mesh, cb,
                                          collective=coll))
            assert _fields(T.sharded_fusedmb_pass_costs(
                ts, th, mesh, cb, coll)) == _fields(
                J.sharded_fusedmb_pass_costs(js, th, mesh, cb,
                                             collective=coll))
            assert _fields(T.sharded_fusedmb_staged_traffic(
                ts, th, mesh, cb, coll)) == _fields(
                J.sharded_fusedmb_staged_traffic(js, th, mesh, cb, coll))
            dp, mp = T.shard_factors(ts.b, ts.c_mid, mesh)
            assert T._fusedmb_collective_words(ts, dp, mp, coll) == \
                J._fusedmb_collective_words(js, dp, mp, coll)
        for fn in (T.sharded_fusedmb_traffic, T.sharded_fusedmb_pass_costs,
                   T.sharded_fusedmb_staged_traffic):
            with pytest.raises(ValueError, match="replicated"):
                fn(ts, 4, mesh, in_layout="model_sharded")


@pytest.mark.parametrize("mesh", MESHES)
def test_separable_mesh_pricing_equals_jax(mesh):
    for b, hw, ci, _cm, co, k, s, _se in BLOCKS:
        kw = dict(b=b, h=hw, w=hw, c_in=ci, c_out=co, k=k, s=s)
        js, ts = J.SeparableShape(**kw), T.SeparableShape(**kw)
        for lay in T.LAYOUT_MODES:
            jl, je = J.separable_shard(js, mesh, lay)
            tl, te = T.separable_shard(ts, mesh, lay)
            assert (vars(tl), te) == (vars(jl), je)
            for th, cb, coll in itertools.product(TILES, C_BLOCKS,
                                                  T.COLLECTIVE_MODES):
                assert _fields(T.sharded_separable_traffic(
                    ts, th, mesh, cb, lay, coll)) == _fields(
                    J.sharded_separable_traffic(js, th, mesh, cb,
                                                in_layout=lay,
                                                collective=coll))
                dp, mp = T.shard_factors(b, ci, mesh)
                assert T._separable_collective_words(ts, dp, mp, coll) == \
                    J._separable_collective_words(js, dp, mp, coll)
        for th in TILES:
            assert _fields(T.sharded_separable_staged_traffic(
                ts, th, mesh)) == _fields(
                J.sharded_separable_staged_traffic(js, th, mesh))


@pytest.mark.parametrize("mesh", MESHES)
def test_layout_transitions_and_scatter_width_equal_jax(mesh):
    for (b, h, w, c), prod, cons in itertools.product(
            [(8, 14, 14, 112), (8, 7, 7, 114), (3, 5, 5, 16)],
            T.LAYOUT_MODES, T.LAYOUT_MODES):
        assert T.layout_transition_words(b, h, w, c, mesh, prod, cons) == \
            J.layout_transition_words(b, h, w, c, mesh, prod, cons)
    for c_out in (1, 7, 16, 114):
        assert T.scatter_c_out(c_out, mesh[1]) == \
            J.scatter_c_out(c_out, mesh[1])


def test_overlap_and_latency_helpers_equal_jax():
    coeffs = (T.PerfCoefficients(35.7, -0.78, 0.017, 0.0, 212, 51.5),
              J.PerfCoefficients(35.7, -0.78, 0.017, 0.0, 212, 51.5))
    js, ts = _shapes(BLOCKS[0])
    for mesh in MESHES:
        jc = J.sharded_mbconv_pass_costs(js, 4, "retain", mesh)
        tc = T.sharded_mbconv_pass_costs(ts, 4, "retain", mesh)
        for j_p, t_p, words in ((jc.pass1, tc.pass1,
                                 tc.pass1_collective_words),
                                (jc.pass2, tc.pass2,
                                 tc.pass2_collective_words)):
            assert T.mbconv_pass_us(coeffs[0], t_p, words) == \
                J.mbconv_pass_us(coeffs[1], j_p, words)
    for p2, p1 in ((3.0, 5.0), (0.0, 2.0), (7.5, 7.5)):
        for ov in T.OVERLAP_MODES:
            assert T.boundary_overlap_us(p2, p1, ov) == \
                J.boundary_overlap_us(p2, p1, ov)
        assert T.overlap_saving_us(p2, p1) == J.overlap_saving_us(p2, p1)


def test_pod_mesh_prices_at_its_folded_factors():
    """A ("pod", "data", "model") mesh folds the pod into the data factor,
    in the port's wrappers as in the JAX package's, and the model prices
    it at the folded pair."""
    pod = types.SimpleNamespace(shape={"pod": 2, "data": 1, "model": 2})
    assert TS.conv_mesh_shape(pod) == JS.conv_mesh_shape(pod) == (2, 2)
    assert TS._batch_axes(pod) == ("pod", "data")
    assert TS.can_shard_fused(pod, 4, 16) == JS.can_shard_fused(pod, 4, 16)
    assert not TS.can_shard_fused(pod, 3, 16)
    js, ts = _shapes(BLOCKS[0])
    folded = TS.conv_mesh_shape(pod)
    assert _fields(T.sharded_mbconv_traffic(ts, 4, "retain", folded)) == \
        _fields(J.sharded_mbconv_traffic(js, 4, "retain", folded))

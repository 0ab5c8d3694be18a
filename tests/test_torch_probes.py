"""The port's probes (nbody_tpu_torch.tools: tree_phase_bench,
clustered_stress, clustered_phase, bh_bigN_probe, bh_near_probe, bh_tune,
bvh_bench, bvh_far_flip_probe, local_leaf_check, smalln_floor,
segmented_probe, brute_variants, mxu_narrow_bench) against the repo's
JAX tools in ``tools/`` and the JAX package, on the CPU.

Tolerances:
- defaults, seeds, sweep lists, overflow stats, escalated caps and the
  padded subset: equal (read from the JAX tools' sources with ``ast``);
- ``sampled_oracle_error``: 1e-12 relative (both are host numpy f64);
- tree_phase_bench's ablations on one f64 tree carried from the JAX
  package: 1e-10 scale-normalized (the same operations in other orders);
- local_leaf_check's errors in f64: 1e-10 relative;
- brute_variants' rows in fp32: 1e-4 scale-normalized against the JAX
  package's blocked sum (the JAX kernel tests' own tolerance); the mxu
  rows within 64 fp32 ulps of their cancellation scale (``MXU_ULPS``, the
  gate ``chip_smoke.py`` [10] holds K5 to) against the f64 sum;
- segmented_probe: its own checks (3e-4), through the plain versions.

Tests marked ``cuda`` run each probe at a tiny size on the card and skip
without one.
"""

import argparse
import ast
import dataclasses
import json
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))

import clustered_stress as jcs  # noqa: E402  (the JAX tool)
from nbody_tpu.config import GravityConfig as JGravity  # noqa: E402
from nbody_tpu.ops import grid_tree as jg  # noqa: E402
from nbody_tpu.ops.brute_force import brute_force_blocked  # noqa: E402
from nbody_tpu.ops.bvh import _bvh_fused  # noqa: E402
from nbody_tpu.ops.fmm import fmm_accel_sorted as jfmm  # noqa: E402
from nbody_tpu.ops.keys import MAX_BITS  # noqa: E402
from nbody_tpu.utils.accuracy import \
    scale_normalized_error as jerr  # noqa: E402
from nbody_tpu_torch.config import GravityConfig as TGravity  # noqa: E402
from nbody_tpu_torch.ops import grid_tree as tg  # noqa: E402
from nbody_tpu_torch.ops.cuda_brute import brute_force_cuda  # noqa: E402
from nbody_tpu_torch.state import plummer_system  # noqa: E402
from nbody_tpu_torch.tools import (bh_bigN_probe, bh_near_probe,  # noqa
                                   bh_tune, brute_variants, bvh_bench,
                                   bvh_far_flip_probe, clustered_phase,
                                   clustered_stress, local_leaf_check,
                                   mxu_narrow_bench, segmented_probe,
                                   smalln_floor, tree_phase_bench)
from nbody_tpu_torch.utils.accuracy import \
    scale_normalized_error  # noqa: E402

torch.set_num_threads(2)

#: K5's form ("mxu") returns a[:D] - (x_t - c)·a[D], two terms of size
#: |x_t - c|·a[D] that cancel down to the acceleration, so its error is
#: held in fp32 ulps of that scale (as ``chip_smoke.py`` [10] holds K5):
#: scale-normalized it depends on the draw and the block (on these bodies
#: 2.6e-3 / 4.1e-3 / 1.5e-2 at block_t 128 / 256 / 512; the JAX package's
#: plain form reads 1.8e-3 / 2.2e-3 / 9.0e-3).
MXU_ULPS = 64


def _mxu_error_ulps(pos, mass, cfg, got, block_t) -> float:
    """The largest error of K5's form over every body, in fp32 ulps of each
    body's cancellation scale, against the f64 one-sided sum (the bodies in
    the wrapper's Morton order, c the first of each block of ``block_t``)."""
    from nbody_tpu_torch.ops.brute_force import _accel_rows, _diffs_d2, \
        _guarded_u3
    from nbody_tpu_torch.ops.keys import morton_key
    order = torch.argsort(morton_key(pos), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel())
    c = pos[order[rank // block_t * block_t]].double()
    p64, m64 = pos.double(), mass.double()
    want = _accel_rows(p64, p64, m64, cfg.softening)
    a_d = (_guarded_u3(_diffs_d2(p64, p64)[1], cfg.softening) * m64).sum(1)
    scale = torch.maximum((p64 - c).norm(dim=1) * a_d, want.norm(dim=1))
    have = got.double() / (cfg.G * m64)[:, None]
    return float(((have - want).norm(dim=1) / scale).max()) / 2.0 ** -24

PROBES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    tree_phase_bench, clustered_stress, clustered_phase, bh_bigN_probe,
    bh_near_probe, bh_tune, bvh_bench, bvh_far_flip_probe, local_leaf_check,
    smalln_floor, segmented_probe, brute_variants, mxu_narrow_bench)}
#: JAX flags the port replaces: output paths (``--out`` there is under
#: ``artifacts/``, here under ``results/torch/``) and ``--cpu`` (here
#: ``--device cpu``).
REPLACED = {"out", "cpu"}
#: The JAX tools' p2p_impl names in the port's.
P2P_NAMES = {"jnp": "plain", "pallas": "cuda"}


def _jax_source(name):
    return ast.parse((TOOLS / f"{name}.py").read_text())


def _jax_defaults(name) -> dict:
    """dest → default of every ``add_argument`` in the JAX tool whose
    default is a literal (store_true flags: False)."""
    out = {}
    for node in ast.walk(_jax_source(name)):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            continue
        dest = node.args[0].value.lstrip("-").replace("-", "_")
        kw = {k.arg: k.value for k in node.keywords}
        if "default" in kw:
            try:
                out[dest] = ast.literal_eval(kw["default"])
            except ValueError:
                continue  # a path expression
        elif getattr(kw.get("action"), "value", "") == "store_true":
            out[dest] = False
    return out


class _Parsed(Exception):
    pass


def _port_defaults(module) -> dict:
    """The namespace the port probe's own parser makes of no arguments."""
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(orig(self, args, namespace))
    argparse.ArgumentParser.parse_args = capture
    try:
        module.main([])
    except _Parsed as e:
        return vars(e.args[0])
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("main() returned before parsing its arguments")


def _jax_key_seeds(name) -> set:
    return {node.args[0].value for node in ast.walk(_jax_source(name))
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", "") == "key"}


@pytest.mark.parametrize("name", sorted(PROBES))
def test_defaults_equal_the_jax_tools(name):
    want = _jax_defaults(name)
    have = _port_defaults(PROBES[name])
    assert have["device"] == "cuda"
    for dest, value in want.items():
        if dest in REPLACED:
            continue
        if dest == "impls" and name == "bh_near_probe":
            value = ",".join(P2P_NAMES[x] for x in value.split(","))
        assert dest in have, (name, dest)
        assert have[dest] == value, (name, dest, have[dest], value)
    assert set(have) - set(want) <= {"device", "out"}, set(have) - set(want)
    seeds = _jax_key_seeds(name)
    if hasattr(PROBES[name], "SEED"):
        assert seeds == {PROBES[name].SEED}
    elif name == "segmented_probe":
        assert seeds == {3, 4}


def test_module_constants_equal_the_jax_tools():
    consts = {}
    for node in _jax_source("smalln_floor").body:  # module level
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Tuple):
            names = [t.id for t in node.targets[0].elts]
            consts.update(zip(names, ast.literal_eval(node.value)))
    assert (consts["K_LO"], consts["K_HI"]) == (smalln_floor.K_LO,
                                               smalln_floor.K_HI)
    # smalln_floor's variants: the JAX record's keys, mapped.
    jax_variants = next(
        [ast.literal_eval(k) for k in node.value.keys]
        for node in ast.walk(_jax_source("smalln_floor"))
        if isinstance(node, ast.Assign)
        and getattr(node.targets[0], "id", "") == "variants")
    assert sorted(smalln_floor.JAX_KEYS.values()) == sorted(
        jax_variants + ["fused"])
    assert list(smalln_floor.graph_variants(TGravity())) == [
        k for k, v in smalln_floor.JAX_KEYS.items() if v in jax_variants]
    # mxu_narrow_bench: the shapes, the dtypes and the chain of 64.
    tree = _jax_source("mxu_narrow_bench")
    shapes = next(ast.literal_eval(node.iter) for node in ast.walk(tree)
                  if isinstance(node, ast.For)
                  and isinstance(node.target, ast.Tuple))
    assert [tuple(s) for s in mxu_narrow_bench.SHAPES] == list(shapes)
    dtypes = next([e.attr for e in node.iter.elts]
                  for node in ast.walk(tree) if isinstance(node, ast.For)
                  and getattr(node.target, "id", "") == "dtype")
    assert {"bfloat16", "float32"} == set(dtypes)
    assert {label for label, *_ in mxu_narrow_bench.LIBRARY_ROWS} >= set(
        dtypes)
    bench = next(node for node in ast.walk(tree)
                 if isinstance(node, ast.FunctionDef) and node.name == "bench")
    defaults = dict(zip([a.arg for a in bench.args.args[-2:]],
                        [ast.literal_eval(d) for d in bench.args.defaults]))
    assert defaults == {"reps": mxu_narrow_bench.REPS,
                        "iters": mxu_narrow_bench.ITERS}
    # clustered_stress's --sparse-tune grid.
    loops = {node.target.id: ast.literal_eval(node.iter)
             for node in ast.walk(_jax_source("clustered_stress"))
             if isinstance(node, ast.For)
             and isinstance(node.target, ast.Name)
             and isinstance(node.iter, ast.Tuple)}
    assert loops == {"cs": clustered_stress.TUNE_CHUNKS,
                     "wd": clustered_stress.TUNE_WINDOWS}
    # tree_phase_bench's ablations, in the JAX tool's order (the first two
    # fields of each row: the BH labels are f-strings).
    fmm_rows, bh_rows = [
        [tuple(ast.literal_eval(e) for e in row.elts[:2])
         for row in node.iter.elts]
        for node in ast.walk(_jax_source("tree_phase_bench"))
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple)]
    assert [(s or "", label) for s, label in fmm_rows] == list(
        tree_phase_bench.FMM_ABLATIONS)
    assert bh_rows == [(s, f) for s, f, _ in tree_phase_bench.BH_ABLATIONS]


# --- clustered_stress --------------------------------------------------------

def test_sampled_oracle_error_equals_the_jax_tools():
    rng = np.random.default_rng(5)
    n = 3000
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.0, n).astype(np.float32) / n
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    for g, soft in ((1.0, 0.05), (4.471e-21, 1e-6)):
        for samples in (64, 512):
            want = jcs.sampled_oracle_error(pos, mass, forces,
                                            JGravity(G=g, softening=soft),
                                            samples=samples)
            have = clustered_stress.sampled_oracle_error(
                torch.from_numpy(pos), torch.from_numpy(mass),
                torch.from_numpy(forces), TGravity(G=g, softening=soft),
                samples=samples)
            assert abs(have - want) <= 1e-12 * abs(want)


def test_dense_layout_refuses_plummer_as_the_jax_package():
    s = plummer_system(10_000, 3, generator=torch.Generator().manual_seed(11),
                       device="cpu")
    cfg = TGravity(G=1.0, softening=4.0 / 10_000)
    with pytest.raises(tg.GridCapacityError, match="bvh_forces"):
        tg.barnes_hut_grid(s.positions, s.masses, cfg, theta=0.25,
                           layout="dense")
    with pytest.raises(ValueError, match="bvh_forces"):
        jg.barnes_hut_grid(jnp.asarray(s.positions.numpy()),
                           jnp.asarray(s.masses.numpy()),
                           JGravity(G=1.0, softening=4.0 / 10_000),
                           theta=0.25, layout="dense")


# --- tree_phase_bench ---------------------------------------------------------

def _carry(jtree):
    fields = {f.name: getattr(jtree, f.name)
              for f in dataclasses.fields(jtree)}
    return tg.grid_tree_from_numpy(
        {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
             else v if isinstance(v, int) else np.asarray(v))
         for k, v in fields.items()}, device="cpu")


def _same_acc(have, want, tol=1e-10):
    want = np.asarray(want)
    if not np.any(want):
        assert not torch.any(have)
        return
    assert float(scale_normalized_error(have, want)) < tol


@pytest.mark.parametrize("fmm", [False, True])
def test_tree_phase_ablations_equal_the_jax_package(fmm):
    n, dim, theta, order = 4096, 2, 0.5, 3
    rng = np.random.default_rng(0)
    pos = rng.uniform(1.0, 1e7, (n, dim))
    mass = rng.uniform(1.0, 1e8, n)
    k = jg.theta_to_ring(theta)
    level = tree_phase_bench.leaf_level(n, dim, theta, fmm)
    assert level == (jg.auto_leaf_level(n, dim, target_occupancy=32) if fmm
                     else jg.auto_leaf_level(n, dim, k=k))
    cap = jg.compute_capacity(jnp.asarray(pos), level)
    jtree = jg.build_grid_tree(jnp.asarray(pos), jnp.asarray(mass), level,
                               cap, quad=not fmm)
    tree = _carry(jtree)
    soft = float(TGravity().softening)
    if fmm:
        for skip, _ in tree_phase_bench.FMM_ABLATIONS:
            _same_acc(tree_phase_bench.fmm_ablation(tree, order, soft, skip),
                      jfmm(jtree, order=order, ring=1, softening=soft,
                           _debug_skip=skip))
    else:
        for skip, far_impl, _ in tree_phase_bench.BH_ABLATIONS:
            _same_acc(tree_phase_bench.bh_ablation(tree, k, soft, far_impl,
                                                   skip),
                      jg.grid_tree_accel_sorted(
                          jtree, k=k, softening=soft, multipole="quad",
                          far_impl=far_impl, _debug_skip=skip))


# --- clustered_phase ----------------------------------------------------------

def _jax_statements(tool, targets):
    """The source lines of the JAX tool's assignments to ``targets``."""
    src = (TOOLS / f"{tool}.py").read_text()
    return [ast.get_source_segment(src, node)
            for node in ast.walk(ast.parse(src))
            if isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in targets]


def test_base_walk_overflow_stats_equal_the_jax_package():
    n, dim, theta, soft = 4096, 3, 0.5, 0.05
    s = plummer_system(n, dim, generator=torch.Generator().manual_seed(3),
                       device="cpu", dtype=torch.float64)
    pos, mass = s.positions, s.masses
    cap, walk = clustered_phase.walk_settings(n, dim, theta, soft, "point")
    assert (cap, walk["group_size"]) == (min(8192, 2 * n), min(1024, n))
    w = nl = 64  # tight: groups overflow
    _, need_w, need_nl, ids, _ = clustered_phase.base_walk(
        pos, mass, TGravity(G=1.0, softening=soft), walk, w, nl)
    _, maxw, ncnt, g_over, _ = _bvh_fused(
        jnp.asarray(pos.numpy()), jnp.asarray(mass.numpy()), jnp.float64(1.0),
        key_bits=dim * MAX_BITS[dim], quad=True, leaf_size=16, theta=theta,
        softening=soft, group_size=1024, batch=128, frontier_width=w,
        near_cap=nl, multipole="quad", far_impl="point")
    assert (need_w, need_nl) == (int(maxw), int(ncnt))
    np.testing.assert_array_equal(ids, np.nonzero(np.asarray(g_over))[0])
    assert 0 < ids.size and need_w > w and need_nl > nl

    # The escalated caps and the padded subset: the JAX tool's own lines.
    scope = {"np": np, "n": n, "w": w, "nl": nl, "need_w": need_w,
             "need_nl": need_nl, "ids": ids}
    for stmt in _jax_statements("clustered_phase",
                                {"w2", "nl2", "M", "ids_p"}):
        exec(stmt, scope)
    assert clustered_phase.escalated_caps(n, w, nl, need_w, need_nl) == (
        scope["w2"], scope["nl2"])
    np.testing.assert_array_equal(clustered_phase.padded_subset(ids),
                                  scope["ids_p"])
    for case in ((100, 64, 64, 50, 70), (100, 64, 64, 150, 10),
                 (5000, 64, 64, 90, 30)):
        scope.update(zip(("n", "w", "nl", "need_w", "need_nl"), case))
        for stmt in _jax_statements("clustered_phase", {"w2", "nl2"}):
            exec(stmt, scope)
        assert clustered_phase.escalated_caps(*case) == (scope["w2"],
                                                         scope["nl2"])
    for m in (1, 3, 4, 5, 9):
        scope["ids"] = np.arange(2, 2 + m)
        for stmt in _jax_statements("clustered_phase", {"M", "ids_p"}):
            exec(stmt, scope)
        np.testing.assert_array_equal(
            clustered_phase.padded_subset(scope["ids"]), scope["ids_p"])


# --- local_leaf_check ---------------------------------------------------------

def test_local_leaf_errors_equal_the_jax_package():
    # 2D: at N = 2000 3D the auto level's k = 3 ring covers every cell, so
    # every far_impl is the direct sum (all four read 1.5e-15 in f64), and
    # the plain f64 near field takes ~40 s on the CPU there. At 4096 2D the
    # four far fields differ (~4e-6 to 1e-5).
    rng = np.random.default_rng(1)
    n, dim, theta = 4096, 2, 0.25
    pos = rng.uniform(1.0, 1e7, (n, dim))
    mass = rng.uniform(1.0, 1e8, n)
    rows = local_leaf_check.far_impl_rows(torch.from_numpy(pos),
                                          torch.from_numpy(mass), TGravity(),
                                          theta)
    assert [r["far_impl"] for r in rows] == ["point", "local", "local_leaf",
                                             "hier"]
    cfg = JGravity()
    ref = brute_force_blocked(jnp.asarray(pos), jnp.asarray(mass), cfg)
    for r in rows:
        f = jg.barnes_hut_grid(jnp.asarray(pos), jnp.asarray(mass), cfg,
                               theta=theta, far_impl=r["far_impl"])
        want = float(jerr(f, ref))
        assert abs(r["err"] - want) <= 1e-10 * want, (r, want)
        assert np.isfinite(r["acc"])
    assert len({r["err"] for r in rows}) == len(rows)  # a far field each


# --- segmented_probe, brute_variants -----------------------------------------

def test_segmented_probe_checks_pass_through_the_plain_versions(
        monkeypatch, tmp_path):
    monkeypatch.setattr(segmented_probe, "CHECK_N", 2500)
    out = tmp_path / "seg.json"
    assert segmented_probe.main(["--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["n"] == 2500
    assert 0 < rec["err_seg3_vs_symmetric"] < segmented_probe.TOL
    assert 0 < rec["err_seg5_vs_seg3"] < segmented_probe.TOL


def test_brute_variants_cover_every_mode_and_match_the_jax_oracle(tmp_path):
    kws = [kw for _, kw in brute_variants.VARIANTS]
    assert {(kw["mode"], kw["guard"]) for kw in kws if "guard" in kw} == {
        (m, g) for m in ("precise", "symmetric") for g in (True, False)}
    assert {kw["block_t"] for kw in kws if kw["mode"] == "mxu"} == {128, 256,
                                                                   512}
    with pytest.raises(ValueError, match="'precise', 'mxu' or 'symmetric'"):
        brute_force_cuda(torch.zeros(4, 2), torch.ones(4), mode="other")
    rng = np.random.default_rng(2)
    n = 1024
    pos = rng.uniform(1.0, 1e7, (n, 2)).astype(np.float32)
    mass = rng.uniform(1.0, 1e8, n).astype(np.float32)
    want = np.asarray(brute_force_blocked(jnp.asarray(pos), jnp.asarray(mass),
                                          JGravity()))
    tpos, tmass = torch.from_numpy(pos), torch.from_numpy(mass)
    for label, kw in brute_variants.VARIANTS:
        have = brute_force_cuda(tpos, tmass, TGravity(), **kw)
        if kw["mode"] == "mxu":
            assert _mxu_error_ulps(tpos, tmass, TGravity(), have,
                                   kw["block_t"]) < MXU_ULPS, label
        else:
            assert float(scale_normalized_error(have, want)) < 1e-4, label
    out = tmp_path / "bv.json"
    assert brute_variants.main(["--n", "1024", "--device", "cpu", "--out",
                                str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["label"] for r in rows] == [brute_variants.ORACLE] + [
        label for label, _ in brute_variants.VARIANTS]
    assert all(r["checksum_rel_diff"] < 1e-4 for r in rows)


# --- the sweeps ---------------------------------------------------------------

#: (probe, tiny argv, the function its rows call, rows in the sweep, the
#: printed row's pattern).
SWEEPS = {
    "bh_tune": (["--n", "1500", "--dim", "2"], "barnes_hut_grid", 4 * 3,
                r"^  L=\d+ \(cells=.* batch=\d+: [\d.]+ s$"),
    "bh_near_probe": (["--n", "1500", "--dim", "2", "--impls",
                       "plain,plain"], "grid_tree_accel_sorted", 2 * 2 * 2,
                      r"^  L=\d+ cap=.* near=\s*[\d.]+ ms"),
    "bvh_bench": (["--cases", "600:2,300:3", "--leaf-sizes", "8,16"],
                  "bvh_forces", 2 * 2 * 2,
                  r"^N=\s*\d+ \dD .* [\d.]+ ms  checksum="),
    "bh_bigN_probe": (["--cases", "1500:2,700:3,900:2"], "barnes_hut_grid",
                      3, r"^N=\s*\d+ \dD\s+[\d.]+ s warm"),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_prints_a_row_each_point(name, tmp_path, capsys):
    argv, _, rows, pattern = SWEEPS[name]
    out = tmp_path / "rec.json"
    assert PROBES[name].main(argv + ["--device", "cpu", "--out",
                                     str(out)]) == 0
    rec = json.loads(out.read_text())
    assert len(rec["rows"]) == rows
    assert not any("error" in r for r in rec["rows"])
    printed = [line for line in capsys.readouterr().out.splitlines()
               if re.match(pattern, line)]
    assert len(printed) == rows, printed


@pytest.mark.parametrize("name", sorted(SWEEPS))
@pytest.mark.parametrize("exc", [torch.OutOfMemoryError("out of memory"),
                                 tg.GridCapacityError("too clustered"),
                                 RuntimeError("a fault")],
                         ids=["oom", "capacity", "other"])
def test_sweep_records_only_memory_and_capacity_failures(name, exc,
                                                         monkeypatch,
                                                         tmp_path):
    argv, fn, rows, _ = SWEEPS[name]

    def fail(*args, **kw):
        raise exc
    monkeypatch.setattr(PROBES[name], fn, fail)
    out = tmp_path / "rec.json"
    argv = argv + ["--device", "cpu", "--out", str(out)]
    if isinstance(exc, RuntimeError) and not isinstance(
            exc, torch.OutOfMemoryError):
        with pytest.raises(RuntimeError, match="a fault"):
            PROBES[name].main(argv)
        return
    assert PROBES[name].main(argv) == 0
    rec = json.loads(out.read_text())
    assert len(rec["rows"]) == rows
    assert all(r["error"].startswith(type(exc).__name__)
               for r in rec["rows"])


def test_far_flip_rows_are_keyed_by_theta(tmp_path, capsys):
    out = str(tmp_path / "flip.json")
    base = ["--cases", "400:2", "--samples", "16", "--impls", "point",
            "--device", "cpu", "--out", out]
    for theta in ("0.25", "0.5", "0.25"):
        assert bvh_far_flip_probe.main(base + ["--theta", theta]) == 0
    rows = json.load(open(out))["rows"]
    assert [(r["n"], r["dim"], r["far_impl"], r["theta"]) for r in rows] == [
        (400, 2, "point", 0.25), (400, 2, "point", 0.5)]
    assert all(r["sampled_oracle_error"] < 1e-3 for r in rows)
    # The JAX tool's key would have kept one row of the three runs.
    assert len({(r["n"], r["dim"], r["far_impl"]) for r in rows}) == 1


# --- the card-only tools ------------------------------------------------------

@pytest.mark.parametrize("name", ["smalln_floor", "mxu_narrow_bench"])
def test_card_only_tools_exit_2_on_the_cpu(name, tmp_path):
    out = tmp_path / "x.json"
    assert PROBES[name].main(["--device", "cpu", "--out", str(out)]) == 2
    assert not out.exists()


def test_smalln_floor_differencing():
    k = smalln_floor.K_HI - smalln_floor.K_LO
    assert smalln_floor.per_step(0.5, 0.5 + 3.0 * k) == pytest.approx(3.0)
    assert smalln_floor.per_step(1.0, 2.0, 10, 20) == pytest.approx(0.1)


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probes' kernels and CUDA-event "
                    "times run only on the card")
    return torch.device("cuda", 0)


#: Each probe at a tiny size on the card.
CARD_ARGV = {
    "tree_phase_bench": ["--n", "20000"],
    "clustered_stress": ["--n", "10000"],
    "clustered_phase": ["--n", "5000"],
    "bh_bigN_probe": ["--cases", "20000:3"],
    "bh_near_probe": ["--n", "5000", "--impls", "plain,cuda"],
    "bh_tune": ["--n", "5000"],
    "bvh_bench": ["--cases", "5000:2"],
    "bvh_far_flip_probe": ["--cases", "5000:2", "--samples", "64"],
    "local_leaf_check": ["-N", "2000", "--time"],
    "smalln_floor": ["--n", "256"],
    "segmented_probe": [],
    "brute_variants": ["--n", "4096"],
    "mxu_narrow_bench": [],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_ARGV))
def test_probe_runs_on_the_card(name, cuda_device, tmp_path):
    out = tmp_path / "rec.json"
    assert PROBES[name].main(CARD_ARGV[name] + ["--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    card = rec["device"] if "device" in rec else rec["rows"][0]["device"]
    assert card not in ("", "cpu")

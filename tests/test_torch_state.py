"""nbody_tpu_torch config and state against nbody_tpu's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu.config as jcfg
import nbody_tpu.state as jstate
import nbody_tpu_torch.config as tcfg
from nbody_tpu_torch.state import (System, plummer_system, random_system,
                                   system_from_numpy)


@pytest.mark.parametrize("cls", ["GravityConfig", "TreeConfig"])
def test_config_fields_match(cls):
    jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, cls))]
    tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, cls))]
    assert tf == jf


def test_config_constants_match():
    names = [n for n in dir(jcfg) if n.isupper() and "DEFAULT_" not in n]
    assert names and all(getattr(tcfg, n) == getattr(jcfg, n) for n in names)
    for n in ("DEFAULT_GRAVITY", "DEFAULT_TREE"):
        assert (dataclasses.asdict(getattr(tcfg, n))
                == dataclasses.asdict(getattr(jcfg, n)))
    assert tcfg.G_DEFAULT == 4.471e-21 and tcfg.SOFTENING == 1e-6
    assert tcfg.DEFAULT_GRAVITY.replace(G=1.0).G == 1.0


@pytest.mark.parametrize("shapes", [
    ((4, 4), (4, 4), (4,)),   # bad dim
    ((4, 3), (5, 3), (4,)),   # bad velocities
    ((4, 2), (4, 2), (3,)),   # bad masses
])
def test_validate_errors_match(shapes):
    arrs = [np.zeros(s) for s in shapes]
    with pytest.raises(ValueError) as jerr:
        jstate.System(*[jnp.asarray(a) for a in arrs]).validate()
    with pytest.raises(ValueError) as terr:
        system_from_numpy(*arrs, device="cpu").validate()
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_numpy_round_trip(dtype):
    rng = np.random.default_rng(0)
    arrs = (rng.normal(size=(7, 3)).astype(dtype),
            rng.normal(size=(7, 3)).astype(dtype),
            rng.uniform(1, 2, size=7).astype(dtype))
    s = system_from_numpy(*arrs, device="cpu")
    s.validate()
    assert (s.n, s.dim, s.device.type) == (7, 3, "cpu")
    for got, want in zip(s.to_numpy(), arrs):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    s32 = system_from_numpy(*arrs, device="cpu", dtype=torch.float32)
    assert s32.dtype == torch.float32
    assert s.astype(torch.float32).to("cpu").dtype == torch.float32


def test_generator_ranges_and_seeding(dim):
    def make(seed):
        return random_system(4096, dim, generator=torch.Generator()
                             .manual_seed(seed), device="cpu")
    s = make(0)
    s.validate()
    for t, (lo, hi) in [(s.positions, tcfg.POSITION_RANGE),
                        (s.velocities, tcfg.VELOCITY_RANGE),
                        (s.masses, tcfg.MASS_RANGE)]:
        assert float(t.min()) >= lo and float(t.max()) <= hi
    assert torch.equal(make(0).positions, s.positions)
    assert not torch.equal(make(1).positions, s.positions)
    with pytest.raises(ValueError):
        random_system(8, 4, generator=torch.Generator(), device="cpu")


def test_plummer():
    s = plummer_system(1000, 3, generator=torch.Generator().manual_seed(0),
                       device="cpu", total_mass=1.0)
    assert isinstance(s, System)
    assert np.isclose(float(s.masses.sum()), 1.0, rtol=1e-5)
    r = torch.linalg.norm(s.positions, dim=-1)
    # Half-mass radius of a Plummer sphere is ~1.3 scale radii.
    assert 0.5 < float(r.median()) < 3.0
    assert float(s.velocities.abs().max()) == 0.0

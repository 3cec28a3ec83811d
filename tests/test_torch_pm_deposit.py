"""The particle-mesh deposit (`ops/pm.py`): the CUDA kernels
(`csrc/cic_deposit.cu`) and the plain twin, on chip_smoke's adversarial
scenes (`DEPOSIT_SCENES`: the demo's two shells, every particle in one
cell, a uniform cube, parked padding) at small n and G.

- On the CPU the deposit takes the twin. Its float32 error against itself
  in float64 stays under an upper bound on each scene: the rounding of
  each running sum, cancelled at the cell bounds. chip_smoke's phase 15b
  holds the kernels, at 4M and G = 128, to no more than the error of the
  twin run on the card in the same phase.
- The wrappers' refusals.
- On a card (`cuda` marker; these skip without one, and run there with
  `python -m pytest --noconftest -m cuda tests/test_torch_pm_deposit.py`,
  this file imports no JAX): the kernels within `DEPOSIT_LIMIT` of the
  float64 twin, the twin's inside count, bitwise from run to run, on the
  scenes, on partial tiles, with no particles, and on runs that end on,
  one short of or one past a tile's edge.
"""

import pytest
import torch

import chip_smoke
from chip_smoke import DEPOSIT_LIMIT, DEPOSIT_SCENES, deposit_errors, rel_err
from multi_adapter_particles_torch.ops import pm

torch.set_num_threads(1)

BOX = chip_smoke.BOX


def _sorted(name, n, g, seed=7, device="cpu"):
    pos = chip_smoke.deposit_scene(name, n, g, BOX, seed=seed, device=device)
    return pm._sort_by_cell(pos, g, BOX)


@pytest.mark.parametrize("name", DEPOSIT_SCENES)
def test_cpu_deposit_takes_the_twin(name):
    """CPU tensors go to the float32 twin, bitwise; its grid holds one unit
    of mass for each particle inside the margin and none for the rest."""
    g = 16
    sbase, sfrac = _sorted(name, 20_000, g)
    rho, rho32, rho64, inside = deposit_errors(sbase, sfrac, g)
    assert rho.dtype == torch.float32 and rho64.dtype == torch.float64
    assert torch.equal(rho, rho32)
    live = int((sbase < g ** 3).sum())
    assert int(inside) == live
    assert float(rho64.sum()) == pytest.approx(live, rel=1e-12)
    if name == "parked padding":
        assert live == 20_000 - 20_000 // 4 - 8


@pytest.mark.parametrize("name,g,high", [
    # the shells: ~5e4 counts of running sum a corner, differenced at the
    # bounds of cells of ~100
    ("two shells", 32, 4e-5),
    # one cell: the difference is the running sum's end, within one
    # float32 ulp of it
    ("one cell", 32, 2.0 ** -23),
    # a cube of ~3 a cell loses most: the running sum climbs as high over
    # cells that hold a few counts
    ("uniform cube", 32, 1e-3),
])
def test_twin_float32_error_bounded(name, g, high):
    sbase, sfrac = _sorted(name, 65_536, g)
    _, rho32, rho64, _ = deposit_errors(sbase, sfrac, g)
    assert rel_err(rho32, rho64) <= high


def test_cuda_wrapper_refuses_cpu_tensors():
    sbase, sfrac = _sorted("two shells", 1_000, 16)
    bounds = pm._segment_bounds(sbase, 16 ** 3)
    with pytest.raises(ValueError, match="runs on cuda"):
        pm.deposit_sorted_cuda(sbase, sfrac, bounds, 16)


@pytest.mark.parametrize("g", [0, 1291])
def test_cuda_wrapper_refuses_grids_past_int32(g):
    empty = torch.zeros((0,), dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\^31"):
        pm.deposit_sorted_cuda(empty, torch.zeros((3, 0)), empty, g)


# -- on the card ---------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the deposit kernels run only there")
    return torch.device("cuda", torch.cuda.current_device())


def _held(sbase, sfrac, g):
    """The kernels' grid within DEPOSIT_LIMIT of the float64 twin, the
    twin's inside count, the same over 3 runs."""
    rho, _, rho64, inside = deposit_errors(sbase, sfrac, g)
    assert bool(torch.isfinite(rho).all())
    assert rel_err(rho, rho64) <= DEPOSIT_LIMIT
    assert int(inside) == int((sbase < g ** 3).sum())
    for _ in range(2):
        again, again_inside = pm._deposit_sorted(sbase, sfrac, g)
        assert torch.equal(again, rho) and torch.equal(again_inside, inside)


@pytest.mark.cuda
@pytest.mark.parametrize("n,g", [(5_000, 16), (65_536, 32)])
@pytest.mark.parametrize("name", DEPOSIT_SCENES)
def test_kernels_vs_float64_twin(card, name, n, g):
    _held(*_sorted(name, n, g, device=card), g)


@pytest.mark.cuda
def test_kernels_with_no_particles(card):
    sbase, sfrac = _sorted("two shells", 0, 16, device=card)
    rho, inside = pm._deposit_sorted(sbase, sfrac, 16)
    assert int(inside) == 0 and not bool(rho.any())


@pytest.mark.cuda
@pytest.mark.parametrize("run", [2047, 2048, 2049, 4096, 6143])
def test_kernels_on_runs_at_tile_edges(card, run):
    """Cells 1, 3, 5, ... of a G = 8 mesh each hold `run` sorted particles
    (tile edges every 2,048), 64 parked ids at G³ after them."""
    g, tile = 8, pm._library().cic_tile()
    assert tile == 2048
    cells = 7
    ids = torch.arange(1, 2 * cells, 2, device=card).repeat_interleave(run)
    sbase = torch.cat([ids, torch.full((64,), g ** 3, device=card)])
    gen = torch.Generator(device=card).manual_seed(run)
    sfrac = torch.rand((3, sbase.shape[0]), generator=gen, device=card)
    _held(sbase, sfrac, g)

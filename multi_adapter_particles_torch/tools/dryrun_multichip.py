"""Multi-device dry run: every mesh path once, at a tiny size.

The port's counterpart of the JAX package's `dryrun_multichip`. On a mesh
of the given devices (a device may repeat: D shards of one card) it runs

- one ring all-pairs step of the mesh engine, the gather render and the
  sharded render of its positions (the two frames must agree to 2e-3);
- a migration to the half mesh and a step there;
- a step on a 2-D (2, D/2) mesh (D >= 4 and even);
- one sharded step of pm_grid with the distributed FFT, p3m with slots
  and p3m with the tree, a reshard to the half mesh and a step there;
- the bit-stable all-pairs schedule across that rescale, which must be
  bitwise two steps on the whole mesh;

and raises on the first fault.

    python -m multi_adapter_particles_torch.tools.dryrun_multichip [D]
        [--device cuda:0]

runs D (default 8) shards of one device (default the first GPU; `cpu`
runs the plain twins).
"""

from __future__ import annotations

import argparse
from typing import Sequence

import torch

from multi_adapter_particles_torch.config import (
    AppConfig,
    RenderConfig,
    SimConfig,
)
from multi_adapter_particles_torch.models import init as pinit
from multi_adapter_particles_torch.parallel import (
    MeshComputeEngine,
    make_mesh,
    make_multislice_mesh,
    make_sharded_step,
    reshard_state,
    shard_state,
)
from multi_adapter_particles_torch.runtime.render_engine import RenderEngine


def _init(n: int, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return pinit.initialize_particles_device(n, generator=gen, device=device)


def _finite(x) -> None:
    t = x if isinstance(x, torch.Tensor) else x.gather("cpu")
    if not bool(torch.isfinite(t).all()):
        raise AssertionError("non-finite positions")


def dryrun(devices: Sequence) -> str:
    """Run every mesh path on a mesh of `devices`; returns the summary."""
    devices = [torch.device(d) for d in devices]
    nd = len(devices)
    mesh = make_mesh(devices)
    n = 128 * nd  # one lane tile a shard
    cfg = SimConfig(num_particles=n, force_model="all_pairs")
    engine = MeshComputeEngine(cfg, mesh, seed=0, bit_stable=False)
    engine.simulate()
    engine.wait_for_gpu()

    render = RenderEngine(RenderConfig(width=256, height=256), devices[0])
    app = AppConfig(num_particles=n, particle_size=10.0)
    render.draw(engine.positions, app)
    render.present()
    # both paths back to back, after present() may have raised dup
    render.mesh = mesh
    out_sh = render.draw(engine.positions, app)
    render.present()
    render.mesh = None
    out = render.draw(engine.positions, app)
    render.present()
    _finite(engine.positions)

    last = engine
    if nd >= 2:
        half = make_mesh(devices[:nd // 2])
        last = MeshComputeEngine(cfg, half, prev=last)
        last.simulate()
    if nd >= 4 and nd % 2 == 0:
        last = MeshComputeEngine(cfg, make_multislice_mesh(2, devices),
                                 prev=last)
        last.simulate()
    last.wait_for_gpu()

    extras = []
    if nd >= 2:
        half = make_mesh(devices[:nd // 2])
        for force, kw, tag in (
            ("pm_grid", dict(pm_distributed_fft=True), "dist-fft pm"),
            ("p3m", dict(p3m_capacity=32), "p3m"),
            ("p3m", dict(p3m_near_mode="tree"), "p3m-tree"),
        ):
            fcfg = SimConfig(num_particles=n, force_model=force,
                             pm_grid_size=32, pm_box=4096.0,
                             interaction_scale=1.0 / n, **kw)
            fstate = make_sharded_step(fcfg, mesh)(
                shard_state(_init(n, 1, devices[0]), mesh))
            _finite(fstate.position)
            fstate = reshard_state(fstate, half)
            fstate = make_sharded_step(fcfg, half)(fstate)
            _finite(fstate.position)
            extras.append(tag + "+reshard")

        s0 = shard_state(_init(n, 2, devices[0]), mesh)
        step_full = make_sharded_step(cfg, mesh, bit_stable=True)
        ctrl = step_full(step_full(s0))
        moved = make_sharded_step(cfg, half, bit_stable=True)(
            reshard_state(step_full(s0), half))
        for a, b in ((moved.position, ctrl.position),
                     (moved.velocity, ctrl.velocity)):
            if not torch.equal(a.gather("cpu"), b.gather("cpu")):
                raise AssertionError(
                    "bit-stable trajectory diverged across the live rescale")
        extras.append("bitstable-rescale")

    _finite(out.frame)
    if not torch.allclose(out_sh.frame.to(out.frame.device), out.frame,
                          rtol=0, atol=2e-3):
        raise AssertionError(
            "sharded render disagrees with the gather-path frame")
    _finite(last.positions)
    return (f"dryrun_multichip({nd}): ok — {n} particles, ring all-pairs + "
            "gather + render + shard-render + reshard"
            + "".join(" + " + t for t in extras))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shards", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        print("error: no GPU (pass --device cpu for the plain twins)")
        return 2
    print(dryrun([args.device] * args.shards), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

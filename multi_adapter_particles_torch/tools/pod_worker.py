"""One process of a multi-process mesh run: the pod path end to end.

The port's counterpart of the JAX suite's bootstrap worker. Each of WORLD
processes runs

    python -m multi_adapter_particles_torch.tools.pod_worker PORT RANK WORLD
        [--shards S] [--device DEV] [--only allpairs,render,pm] ...

and holds S shards of its own device (DEV: default cuda:0; `cpu` runs the
plain twins), so the mesh has S x WORLD ranks. Each process checks what
the JAX worker checks:

- `bootstrap.initialize` reports launched; the world and local counts,
  `is_primary` and `local_render_device`;
- allpairs: a `MeshComputeEngine` on all_pairs (bit-stable) takes
  `--steps` steps, fence == steps; the process all-gather
  (`gather_positions`, landing on the local render device) is bitwise a
  one-device `-rectpair` run;
- render: the central well stepped once on the process mesh (bitwise one
  device) and rendered with `Renderer.render_mesh`: bitwise the same mesh
  in one process, and within 2e-3 of the one-device render;
- pm: one pm_grid step with the distributed FFT, within rtol 1e-5 / atol
  1e-3 of one device;
- mesh: the ring schedule on the process mesh and on a 2-D one, and p3m
  with each near field, each bitwise the same mesh in one process, and a
  reshard onto one rank a process that continues bitwise.

The primary (rank 0) computes the one-process references, prints one line
`POD_RESULT {json}` (backend, reason, host-clock times, the device
launches of each CUDA kernel on its own shards in the allpairs and render
phases, by torch.profiler) and with `--out PATH` saves the gathered
all-pairs positions (.npy). Every process prints `BOOTSTRAP_OK`
last; any failed check exits non-zero. Processes that share one card
time-slice it, so their times gate nothing.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import numpy as np
import torch

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.config import RenderConfig, SimConfig
from multi_adapter_particles_torch.models import init as pinit
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.parallel import (
    MeshComputeEngine,
    bootstrap,
    gather_positions,
    make_mesh,
    make_multislice_mesh,
    make_sharded_step,
    reshard_state,
    shard_state,
)
from multi_adapter_particles_torch.parallel import mesh as M
from multi_adapter_particles_torch.render.camera import Camera
from multi_adapter_particles_torch.render.renderer import Renderer
from multi_adapter_particles_torch.runtime.compute_engine import step_into

PHASES = ("allpairs", "render", "pm", "mesh")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(fn(), host ms with the device drained)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _init(n: int, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return pinit.initialize_particles_device(n, generator=gen, device=device)


def _equal(label: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: not bitwise equal "
                             f"({int((got != want).sum())} values differ)")


def _launches(fn, device, primary: bool):
    """(fn(), {CUDA kernel name: launches}) of one call of `fn` on this
    process, from the device trace (torch.profiler), on the primary only
    (it alone reports them); the plain twins of a CPU run launch none."""
    if device.type != "cuda" or not primary:
        return fn(), {}
    from multi_adapter_particles_torch.tools.allpairs_halfpair import (
        profile_call,
    )

    out, kernels = profile_call(fn)
    return out, dict(collections.Counter(name for name, _ in kernels))


def run_allpairs(mesh, dev, n: int, steps: int, primary: bool, res: dict,
                 out_path=None) -> None:
    cfg = SimConfig(num_particles=n, force_model="all_pairs",
                    all_pairs_half=False)
    eng = MeshComputeEngine(cfg, mesh, seed=0)

    def run():
        for _ in range(steps):
            eng.simulate()
        eng.wait_for_gpu()

    (_, ms), launches = _launches(lambda: _timed(run, dev), dev, primary)
    if eng.get_fence_value() != steps:
        raise AssertionError(f"fence {eng.get_fence_value()} != {steps}")
    full, gather_ms = _timed(lambda: gather_positions(eng.sharded, dev), dev)
    if full.device != bootstrap.local_render_device():
        raise AssertionError(f"gathered onto {full.device}")
    if tuple(full.shape) != (4, n) or not bool(torch.isfinite(full).all()):
        raise AssertionError(f"gathered positions {tuple(full.shape)} not "
                             "finite")
    res["allpairs"] = {"n": n, "steps": steps, "step_ms": ms / steps,
                       "gather_ms": gather_ms, "launches": launches}
    snap = eng.snapshot()
    eng.restore(snap)
    _equal("snapshot / restore", gather_positions(eng.sharded, dev), full)
    if not primary:
        return
    ref = _init(n, 0, dev)
    step = integrator.make_step(cfg)
    for _ in range(steps):
        ref = step(ref)
    _equal("all-pairs process all-gather vs one device -rectpair", full,
           ref.position)
    if out_path:
        np.save(out_path, full.cpu().numpy())


def run_render(mesh, dev, n: int, width: int, height: int, primary: bool,
               res: dict) -> None:
    st = _init(n, 5, dev)
    cfg = SimConfig(num_particles=n)
    rcfg = RenderConfig(width=width, height=height)
    args = (Camera(), C.INITIAL_PARTICLE_SIZE, C.INITIAL_PARTICLE_INTENSITY)

    def run():
        stepped, step_ms = _timed(
            lambda: make_sharded_step(cfg, mesh)(shard_state(st, mesh)), dev)
        out, ms = _timed(lambda: Renderer(rcfg).render_mesh(
            stepped.position, *args, mesh), dev)
        return stepped, step_ms, out, ms

    (stepped, step_ms, out, ms), launches = _launches(run, dev, primary)
    frame = out.frame
    if not bool(torch.isfinite(frame).all()) or float(frame.max()) <= 0.0:
        raise AssertionError("the process-mesh frame is empty or not finite")
    res["render"] = {"n": n, "size": [width, height], "step_ms": step_ms,
                     "frame_ms": ms, "launches": launches}
    full = gather_positions(stepped, dev)  # every process takes part
    if not primary:
        return
    one = st.empty_like()  # the one-device engine's step (the kernel)
    step_into(cfg, integrator.make_step(cfg), st, one, None)
    _equal("central well on the process mesh vs one device", full,
           one.position)
    local = M.Mesh([dev] * mesh.size, (M.AXIS,), (mesh.size,))
    want = Renderer(rcfg).render_mesh(shard_state(one, local).position,
                                      *args, local)
    _equal("process-mesh render vs the one-process render_mesh",
           frame, want.frame)
    for name in ("truncated", "span_y", "span_x"):
        _equal(f"render {name}", getattr(out, name), getattr(want, name))
    single = Renderer(rcfg).render_arrays(one.position, *args).frame
    err = float((frame - single).abs().max())
    if err > 2e-3:
        raise AssertionError(f"render vs one device: max err {err:.3e}")
    res["render"]["vs_one_device_max_err"] = err


def run_pm(mesh, dev, n: int, grid: int, primary: bool, res: dict) -> None:
    cfg = SimConfig(num_particles=n, force_model="pm_grid",
                    pm_grid_size=grid, pm_distributed_fft=True)
    st = _init(n, 3, dev)
    step = make_sharded_step(cfg, mesh)
    out, ms = _timed(lambda: step(shard_state(st, mesh)), dev)
    full = gather_positions(out, dev)
    res["pm"] = {"n": n, "grid": grid, "step_ms": ms}
    if not primary:
        return
    want = integrator.make_step(cfg)(st).position
    err = (full - want).abs()
    bad = err > 1e-3 + 1e-5 * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"pm_grid dist_fft vs one device: "
                             f"{int(bad.sum())} values out of rtol 1e-5 / "
                             f"atol 1e-3 (max {float(err.max()):.3e})")
    res["pm"]["max_abs_err"] = float(err.max())


def run_mesh(mesh, dev, shards: int, primary: bool, res: dict) -> None:
    """The ring (1-D and, with an even mesh, the 2-D hierarchical one),
    p3m with the tree and the slot near fields, and a reshard onto one
    rank a process: each bitwise the same on one process."""
    n = 128 * mesh.size
    cfg = SimConfig(num_particles=n, force_model="all_pairs",
                    all_pairs_half=False)
    st = _init(n, 2, dev)
    meshes = [(mesh, M.Mesh([dev] * mesh.size, (M.AXIS,), (mesh.size,)))]
    if mesh.size % 2 == 0:
        meshes.append((make_multislice_mesh(2, [dev] * shards),
                       M.Mesh([dev] * mesh.size, (M.OUTER_AXIS, M.AXIS),
                              (2, mesh.size // 2))))
    for spread, local in meshes:
        ring = make_sharded_step(cfg, spread, bit_stable=False)
        got = gather_positions(ring(shard_state(st, spread)), dev)
        if primary:
            want = make_sharded_step(cfg, local, bit_stable=False)(
                shard_state(st, local)).gather(dev)
            _equal(f"ring on {spread}", got, want.position)
    # p3m: the far field's all-reduce, the tree's owner partials reduced
    for near in ("tree", "slots"):
        pcfg = SimConfig(num_particles=n, force_model="p3m",
                         pm_grid_size=32, pm_box=4096.0, p3m_near_mode=near)
        pstep = make_sharded_step(pcfg, mesh)
        got = gather_positions(pstep(shard_state(st, mesh)), dev)
        if primary:
            local = meshes[0][1]
            lstep = make_sharded_step(pcfg, local)
            want = lstep(shard_state(st, local)).gather(dev)
            _equal(f"p3m {near} on the process mesh", got, want.position)
            if int(pstep.overflow) != int(lstep.overflow):
                raise AssertionError(f"p3m {near} overflow {pstep.overflow}"
                                     f" != {lstep.overflow}")
    step = make_sharded_step(cfg, mesh)
    one = make_mesh([dev])
    moved = reshard_state(step(shard_state(st, mesh)), one)
    if moved.mesh != one or len(moved.position.shards) != 1:
        raise AssertionError("reshard onto one rank a process")
    got = gather_positions(make_sharded_step(cfg, one)(moved), dev)
    if primary:
        ref = integrator.make_step(cfg)
        _equal("two steps across a reshard", got, ref(ref(st)).position)
    res["mesh"] = {"ring_meshes": len(meshes), "reshard_to": one.size}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("port", type=int)
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("--shards", type=int, default=2,
                   help="shards (mesh ranks) of this process's device")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--only", default=",".join(PHASES),
                   help="comma-separated subset of " + ",".join(PHASES))
    p.add_argument("--n", type=int, default=512, help="all-pairs particles")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--render-n", type=int, default=0,
                   help="render particles (default 128 a rank)")
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--pm-n", type=int, default=512)
    p.add_argument("--pm-grid", type=int, default=32)
    p.add_argument("--out", default=None,
                   help="the primary saves the gathered all-pairs "
                        "positions here (.npy)")
    a = p.parse_args(argv)
    phases = [x for x in a.only.split(",") if x]
    unknown = set(phases) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")
    torch.set_num_threads(1)
    dev = torch.device(a.device)

    if not bootstrap.initialize(f"127.0.0.1:{a.port}", a.world, a.rank,
                                device=dev):
        raise AssertionError("initialize() must report launched")
    try:
        comm = bootstrap.process_group()
        if torch.distributed.get_world_size() != a.world:
            raise AssertionError("world size")
        if bootstrap.is_primary() != (a.rank == 0):
            raise AssertionError("is_primary")
        if bootstrap.local_render_device() != dev:
            raise AssertionError("local_render_device")
        mesh = make_mesh([dev] * a.shards)
        if mesh.size != a.shards * a.world:
            raise AssertionError(f"mesh of {mesh.size}")
        if mesh.local_ranks != list(range(a.rank * a.shards,
                                          (a.rank + 1) * a.shards)):
            raise AssertionError(f"local ranks {mesh.local_ranks}")
        primary = bootstrap.is_primary()
        res = {"backend": comm.backend, "reason": comm.reason,
               "world": a.world, "shards": a.shards, "mesh_size": mesh.size}
        if "allpairs" in phases:
            run_allpairs(mesh, dev, a.n, a.steps, primary, res, a.out)
        if "render" in phases:
            run_render(mesh, dev, a.render_n or 128 * mesh.size, a.width,
                       a.height, primary, res)
        if "pm" in phases:
            run_pm(mesh, dev, a.pm_n, a.pm_grid, primary, res)
        if "mesh" in phases:
            run_mesh(mesh, dev, a.shards, primary, res)
        if primary:
            print("POD_RESULT " + json.dumps(res), flush=True)
        print(f"BOOTSTRAP_OK rank={a.rank} mesh={mesh.size} "
              f"backend={comm.backend}", flush=True)
    finally:
        bootstrap.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

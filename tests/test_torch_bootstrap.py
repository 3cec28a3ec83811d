"""The port's multi-process bootstrap and its process-spanning mesh.

Mirrors tests/test_parallel.py::TestBootstrap: real gloo clusters of 2 and
4 processes on the CPU, each process running
`multi_adapter_particles_torch.tools.pod_worker` with 2 CPU shards (so
meshes of 4 and 8 ranks). Each worker holds the process mesh bitwise
against a one-process run of the port (the bit-stable all-pairs engine,
the central well, the ring on a 1-D and a 2-D mesh, a reshard), the
sharded render bitwise against the one-process `render_mesh` and within
2e-3 of one device, and the dist_fft pm_grid step within rtol 1e-5 / atol
1e-3 of one device. The parent holds the gathered all-pairs trajectory
against the JAX package's `integrator.make_step` from the same initial
state at tests/test_torch_parallel.py's engine tolerance.

Also: the no-op on a single host, the "launched iff a coordinator is
named" rule with `RANK=0` and no `MASTER_ADDR`, a group that cannot be
created raising, the backend rule, and a mesh's view of another process's
ranks.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from multi_adapter_particles_tpu.config import SimConfig as JSimConfig
from multi_adapter_particles_tpu.models import integrator as jintegrator
from multi_adapter_particles_tpu.models.state import (
    ParticleState as JParticleState,
)

from multi_adapter_particles_torch.models import init as pinit
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.parallel import bootstrap
from multi_adapter_particles_torch.parallel import mesh as M

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N = 512                 # the worker's all-pairs particles
STEPS = 2
WORKER_TIMEOUT_S = 120  # every spawned process
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def no_launcher(monkeypatch):
    for var in LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_multi_process_cluster(nprocs, tmp_path):
    """nprocs gloo processes x 2 CPU shards: every worker check passes, and
    the gathered trajectory agrees with the JAX step."""
    port = _free_port()
    out = tmp_path / "positions.npy"
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "multi_adapter_particles_torch.tools.pod_worker",
         str(port), str(rank), str(nprocs), "--shards", "2", "--device",
         "cpu", "--n", str(N), "--steps", str(STEPS), "--out", str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(nprocs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("pod workers timed out:\n" + "\n".join(outs))
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text
        assert "BOOTSTRAP_OK" in text, text
    line = next(x for x in outs[0].splitlines()
                if x.startswith("POD_RESULT "))
    res = json.loads(line[len("POD_RESULT "):])
    assert res["backend"] == "gloo" and "CPU" in res["reason"]
    assert res["mesh_size"] == 2 * nprocs
    assert res["allpairs"]["steps"] == STEPS
    assert res["render"]["vs_one_device_max_err"] <= 2e-3
    assert res["pm"]["max_abs_err"] <= 1e-3
    assert res["mesh"]["ring_meshes"] == 2

    got = np.load(out)
    init = pinit.initialize_particles_device(
        N, torch.Generator().manual_seed(0), device="cpu")
    pos, vel = init.to_numpy()
    js = JParticleState(jnp.asarray(pos), jnp.asarray(vel))
    step = jintegrator.make_step(
        JSimConfig(num_particles=N, force_model="all_pairs"), donate=False)
    for _ in range(STEPS):
        js = step(js)
    np.testing.assert_allclose(got, np.asarray(js.position), rtol=1e-4,
                               atol=1e-3)


def test_noop_on_single_host(no_launcher):
    assert bootstrap.initialize() is False
    assert bootstrap.process_group() is None
    assert not dist.is_initialized()
    assert bootstrap.is_primary()
    if torch.cuda.is_available():
        assert bootstrap.local_render_device().type == "cuda"
    else:  # never the CPU unless named
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bootstrap.local_render_device()


def test_rank_alone_is_not_a_launch(no_launcher, monkeypatch):
    """RANK=0 (and WORLD_SIZE) without MASTER_ADDR: a plain single host,
    not half a group."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert bootstrap.initialize(device="cpu") is False
    assert not dist.is_initialized()
    assert bootstrap.is_primary()


def test_coordinator_from_environment_needs_its_port(no_launcher,
                                                     monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="MASTER_PORT"):
        bootstrap.initialize(device="cpu")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(ValueError, match="process 2 of a group of 2"):
        bootstrap.initialize(device="cpu")
    assert not dist.is_initialized()


def test_group_failure_raises(no_launcher):
    """The coordinator's port is taken: creating the group raises, and no
    group is left behind."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        port = s.getsockname()[1]
        with pytest.raises(RuntimeError, match="address already in use"):
            bootstrap.initialize(f"127.0.0.1:{port}", 2, 0, device="cpu")
    assert bootstrap.process_group() is None
    assert not dist.is_initialized()


@pytest.mark.parametrize("identities, backend, word", [
    ([("h", "cpu", ""), ("h", "cpu", "")], "gloo", "CPU"),
    ([("h", "cuda", "GPU-a"), ("h", "cuda", "GPU-a")], "gloo", "share"),
    ([("h", "cuda", "GPU-a"), ("h", "cuda", "GPU-b")], "nccl", "distinct"),
    ([("h", "cuda", "GPU-a"), ("g", "cuda", "GPU-a")], "nccl", "distinct"),
    ([("h", "cuda", "GPU-a"), ("h", "cpu", "")], "gloo", "CPU"),
])
def test_backend_rule(identities, backend, word):
    got, reason = bootstrap.choose_backend(identities)
    assert got == backend and word in reason


def test_mesh_sees_only_its_ranks():
    """Process 1 of 2 holding ranks 2-3 of a 4-rank mesh: its shards are
    those two, a remote rank is refused, the plane's width counts all."""
    comm = bootstrap.ProcessGroup(1, 2, torch.device("cpu"), "gloo",
                                  "test", None)
    mesh = M.Mesh(["cpu"] * 4, (M.AXIS,), (4,), owners=[0, 0, 1, 1],
                  comm=comm)
    assert mesh.local_ranks == [2, 3]
    assert mesh.local_index(3) == 1
    with pytest.raises(ValueError, match="held by process 0"):
        mesh.local_index(1)
    x = torch.arange(4 * 512, dtype=torch.float32).reshape(4, 512)
    sh = M.shard(x, mesh)
    assert len(sh.shards) == 2 and sh.shape == (4, 512)
    assert torch.equal(sh.shards[0], x[:, 256:384])
    with pytest.raises(ValueError, match="2 ranks of this process"):
        M.Sharded([x[:, :128]], mesh)
    assert mesh != M.Mesh(["cpu"] * 4, (M.AXIS,), (4,))


def test_state_hand_over_to_the_workers_init():
    """The init the workers draw (CPU generator, seed 0) is one state
    every process makes alike: two draws are bitwise equal."""
    a = pinit.initialize_particles_device(
        N, torch.Generator().manual_seed(0), device="cpu")
    b = pinit.initialize_particles_device(
        N, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(a.position, b.position)
    assert torch.equal(a.velocity, b.velocity)
    back = ParticleState.from_numpy(*a.to_numpy())
    assert torch.equal(back.position, a.position)

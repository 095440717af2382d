"""Device mesh: a (data, model) grid of ranks, one rank a device.

The port of ai_font_renderer_tpu/parallel/mesh.py. The JAX package builds
one ``Mesh`` over the devices of one process and lets GSPMD insert the
collectives. PyTorch has no GSPMD: each device is a process (a rank of a
``torch.distributed`` process group), the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ("data", "model"),
and the collectives are written out, here and in train/step.py:

* the batch shards over ``data``: losses and gradients are averaged over it;
* out_w's columns shard over ``model`` (parallel/sharding.py): each rank
  computes its columns of the sheet; flat enters the projection through
  :meth:`Mesh.model_input`, whose backward sums the ranks' partial dflat,
  and the loss sums every shard's squares through :meth:`Mesh.model_sum`.

Backends, chosen explicitly, with no fallback: NCCL for one card a rank,
gloo on the CPU, and gloo when the caller asks for it for ranks that share
one card (NCCL refuses two ranks on one device). On CUDA tensors gloo does
only ``all_reduce`` and ``broadcast``, so the training path uses those two
alone. On the card the devices are the visible cards; on the CPU the ranks
are the devices, the counterpart of the JAX package's virtual CPU devices.
:func:`launch` starts the ranks of a command, each a Python process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# How launch() tells a process that it is a rank.
RANK_ENV = "AFR_MESH_RANK"
WORLD_ENV = "AFR_MESH_WORLD"
INIT_ENV = "AFR_MESH_INIT"
DEVICE_ENV = "AFR_MESH_DEVICE"
BACKEND_ENV = "AFR_MESH_BACKEND"


class _SumToAll(torch.autograd.Function):
    """y = the sum of x over a group; each rank's gradient passes as it is
    (every rank takes the same y, so its own x enters y once)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToAll(torch.autograd.Function):
    """y = x on every rank of a group; the gradient is the sum of the ranks'
    gradients (each rank's y feeds its own shard of the output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """The whole batch from each rank's rows [start, start + n): a zero
    tensor with this rank's rows written in, summed over the group (adding
    zeros is exact); the gradient is this rank's rows of the whole batch's."""

    @staticmethod
    def forward(ctx, x, start, total, group):
        ctx.rows = (start, start + x.shape[0])
        full = x.new_zeros((total, *x.shape[1:]))
        full[start : start + x.shape[0]] = x
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[lo:hi], None, None, None


class Mesh:
    """A (data, model) mesh, seen from one rank: the axes' sizes, this
    rank's coordinate and the collectives over each axis. The collectives
    of an axis of size 1 return their input, so a mesh of one device needs
    no process group and runs the one-device arithmetic."""

    def __init__(self, data: int = 1, model: int = 1, device_mesh=None):
        self.data, self.model = data, model
        self.device_mesh = device_mesh
        self.data_index, self.model_index = 0, 0
        self.data_group = self.model_group = None
        if device_mesh is not None:
            coordinate = device_mesh.get_coordinate()
            if coordinate is None:
                raise ValueError(f"rank {dist.get_rank()} is not in the {data}x{model} mesh")
            self.data_index, self.model_index = coordinate
            self.data_group = device_mesh.get_group(DATA_AXIS)
            self.model_group = device_mesh.get_group(MODEL_AXIS)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def is_main(self) -> bool:
        """Rank (0, 0): the one that writes a run's files."""
        return self.data_index == 0 and self.model_index == 0

    def __repr__(self) -> str:
        return f"Mesh(data={self.data}, model={self.model}, at ({self.data_index}, {self.model_index}))"

    def any(self, flag: bool, device) -> bool:
        """Whether ``flag`` holds on any rank of the mesh: a decision every
        rank takes alike (a wall-clock budget runs out on each at its own
        moment)."""
        if self.size == 1:
            return flag
        t = torch.tensor([float(flag)], device=device)
        return bool(self.model_sum(self.data_sum(t)).item() > 0)

    # -- data axis -------------------------------------------------------
    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data axis (in place)."""
        if self.data > 1:
            dist.all_reduce(t, group=self.data_group)
        return t

    def data_sum_all(self, tensors: list, mean: bool = False) -> list:
        """Each tensor of ``tensors`` (None stays None) summed, or with
        ``mean`` averaged, over the data axis, in one collective over their
        concatenation."""
        if self.data == 1:
            return list(tensors)
        live = [t for t in tensors if t is not None]
        flat = torch.cat([t.detach().reshape(-1).float() for t in live])
        dist.all_reduce(flat, group=self.data_group)
        if mean:
            flat /= self.data
        out, at = [], 0
        for t in tensors:
            if t is None:
                out.append(None)
                continue
            out.append(flat[at : at + t.numel()].view_as(t).to(t.dtype))
            at += t.numel()
        return out

    def data_mean(self, loss: torch.Tensor, grads: dict) -> tuple[torch.Tensor, dict]:
        """The loss and gradients averaged over the data axis (the explicit
        counterpart of the JAX package's pmean)."""
        if self.data == 1:
            return loss, grads
        out = self.data_sum_all([loss.reshape(1), *grads.values()], mean=True)
        return out[0].reshape(()), dict(zip(grads, out[1:]))

    def data_rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n``, which the data axis divides."""
        if n % self.data:
            raise ValueError(f"a batch of {n} does not split over data={self.data}")
        per = n // self.data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def gather_rows(self, x: torch.Tensor, start: int, total: int) -> torch.Tensor:
        """The whole batch of ``total`` rows from each rank's rows, this
        rank's at ``start`` (its gradient: this rank's rows)."""
        if self.data == 1:
            return x
        return _GatherRows.apply(x, start, total, self.data_group)

    # -- model axis ------------------------------------------------------
    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the model axis; the gradient passes as it is."""
        return t if self.model == 1 else _SumToAll.apply(t, self.model_group)

    def model_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the input of a column-parallel product: the same tensor,
        whose gradient is summed over the model axis."""
        return x if self.model == 1 else _CopyToAll.apply(x, self.model_group)

    def columns(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``t``'s last dimension, which the model axis
        divides."""
        n = t.shape[-1]
        if n % self.model:
            raise ValueError(f"{n} columns do not split over model={self.model}")
        per = n // self.model
        return t[..., self.model_index * per : (self.model_index + 1) * per]

    def gather_columns(self, t: torch.Tensor) -> torch.Tensor:
        """The whole of a tensor split over the model axis by its last
        dimension, on every rank: each shard broadcast in turn."""
        if self.model == 1:
            return t
        parts = []
        for j in range(self.model):
            buf = t.detach().clone() if j == self.model_index else torch.empty_like(t)
            dist.broadcast(buf, group=self.model_group, group_src=j)
            parts.append(buf)
        return torch.cat(parts, dim=-1)


def available_devices() -> list:
    """The devices a mesh can take: one a rank once a process group is up
    (the ranks are the devices); otherwise the visible cards, or the CPU."""
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def mesh_shape(data: int | None, model: int, devices: list) -> tuple[int, int]:
    """The (data, model) shape a mesh over ``devices`` takes, or the JAX
    package's ValueError when they cannot hold it."""
    n = len(devices)
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model={model}")
    if data is None:
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} > {n} devices")
    return data, model


def make_mesh(data: int | None = None, model: int = 1, devices: list | None = None) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    ``data=None`` takes all the remaining devices. A mesh of one device is
    the degenerate case and needs no process group; a larger one is built
    on every rank of the group, which must hold at least data x model
    ranks (the first data x model take part)."""
    data, model = mesh_shape(data, model, available_devices() if devices is None else devices)
    if data * model == 1:
        return Mesh(1, 1)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {data}x{model} mesh needs a process group with a rank per device; start the ranks "
            "with parallel.launch (the CLI's --mesh does)"
        )
    from torch.distributed.device_mesh import init_device_mesh

    # The DeviceMesh's device type names where its DTensors would live; the
    # port keeps plain tensors and takes only the groups, so gloo ranks (on
    # the CPU or sharing a card) build a "cpu" mesh and NCCL ranks a "cuda" one.
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(data, model, init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS)))


def single_device_mesh() -> Mesh:
    return make_mesh(data=1, model=1)


# -- ranks ---------------------------------------------------------------
def default_backend(device: str) -> str:
    """NCCL for one card a rank, gloo on the CPU."""
    return "nccl" if device == "cuda" else "gloo"


def is_rank() -> bool:
    """Whether this process is a rank that :func:`launch` started."""
    return RANK_ENV in os.environ


def init_rank() -> int:
    """Join the process group of the ranks that :func:`launch` started
    (from the environment it set) -> this rank's number. On the card a rank
    takes card ``rank % cards``: its own with NCCL, a shared one with gloo."""
    rank, world = int(os.environ[RANK_ENV]), int(os.environ[WORLD_ENV])
    device = os.environ[DEVICE_ENV]
    backend = os.environ.get(BACKEND_ENV) or default_backend(device)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=os.environ[INIT_ENV], rank=rank, world_size=world)
    return rank


def finish_rank() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def launch(argv: list[str], world: int, device: str = "cuda", backend: str | None = None,
           timeout: float | None = None, store_dir: str | None = None, env: dict | None = None) -> int:
    """Run ``python argv`` as ``world`` ranks on ``device`` ("cuda": a card
    a rank with NCCL, or ranks sharing cards with ``backend="gloo"``;
    "cpu": gloo) and wait for them -> 0, or the first failing rank's exit
    code (124 when ``timeout`` seconds pass). The ranks meet through a
    ``FileStore`` in ``store_dir`` (a temporary directory by default). Rank
    0's output passes through; the others' standard output is dropped,
    their errors kept. When one rank fails or the time is up, every rank
    still running is killed."""
    backend = backend or default_backend(device)
    # The ranks import this package from wherever they start.
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        base = {**os.environ, "PYTHONPATH": path, **(env or {}), WORLD_ENV: str(world), DEVICE_ENV: device,
                BACKEND_ENV: backend, INIT_ENV: "file://" + os.path.join(tmp, "store")}
        procs = [
            subprocess.Popen([sys.executable, *argv], env={**base, RANK_ENV: str(r)},
                             stdout=None if r == 0 else subprocess.DEVNULL)
            for r in range(world)
        ]
        deadline = None if timeout is None else time.monotonic() + timeout
        code = 0
        try:
            while any(p.poll() is None for p in procs):
                failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
                if failed:
                    code = failed[0]
                    break
                if deadline is not None and time.monotonic() > deadline:
                    code = 124
                    break
                time.sleep(0.05)
            else:
                code = next((p.returncode for p in procs if p.returncode), 0)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        return code

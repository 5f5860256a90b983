"""Run a function on N CPU ranks over gloo, and the reference on N forced
host devices, for the port's multi-rank tests.

``run_ranks(fn, world, tmp, ep=1, args=(), kwargs=None, pod=None)``
spawns `world` processes (one intra-op thread each), joins them to a
mesh of (world / ep, ep) (with `pod`, the (pod, world / (pod * ep), ep)
mesh) through a FileStore under `tmp`, calls ``fn(mesh, *args,
**kwargs)`` on each, and
returns the ranks' return values (picklable; numpy arrays travel as
they are).  Every group has a timeout and every join one, so a hang fails
its case instead of the suite.

``run_reference(task, world, tmp, **inputs)`` runs
``tests/torch_dist_reference.py``'s task in a subprocess whose XLA_FLAGS
force `world` host devices (the test process's jax has one), handing the
inputs and the results over as .npz files.
"""
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np
import torch.multiprocessing as mp

TIMEOUT_S = 120.0
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def _child(rank, fn, world, ep, pod, store, out_dir, args, kwargs):
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import close_mesh, init_mesh
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        mesh = init_mesh(world // ep // (pod or 1), ep, pod=pod,
                         device="cpu", store=store, rank=rank,
                         timeout_s=TIMEOUT_S)
        res = fn(mesh, *args, **kwargs)
        close_mesh()
        with open(path, "wb") as f:
            pickle.dump(("ok", res), f)
    except BaseException:   # noqa: BLE001 -- reported to the parent
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def run_ranks(fn, world, tmp, ep=1, args=(), kwargs=None, pod=None):
    tmp = str(tmp)
    run_dir = os.path.join(tmp, f"ranks_{world}_{ep}_{len(os.listdir(tmp))}")
    os.makedirs(run_dir)
    store = os.path.join(run_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(r, fn, world, ep, pod, store, run_dir, args,
                               kwargs or {}))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} did not finish within "
                           f"{TIMEOUT_S} s")
    out = []
    for r in range(world):
        path = os.path.join(run_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} of {world} left no result "
                               f"(exit code {procs[r].exitcode})")
        with open(path, "rb") as f:
            status, res = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} of {world} failed:\n{res}")
        out.append(res)
    return out


def run_reference(task, world, tmp, **inputs):
    """The reference's `task` on `world` forced host devices: a dict of
    numpy arrays."""
    tmp = str(tmp)
    n = len(os.listdir(tmp))
    src = os.path.join(tmp, f"ref_in_{task}_{n}.npz")
    dst = os.path.join(tmp, f"ref_out_{task}_{n}.npz")
    np.savez(src, **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={world}")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_dist_reference.py"),
         task, src, dst], env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S * 2)
    if proc.returncode:
        raise RuntimeError(f"reference task {task} failed:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    with np.load(dst) as f:
        return {k: f[k] for k in f.files}

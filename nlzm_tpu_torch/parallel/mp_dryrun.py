"""Multi-process block sharding on torch.distributed: one process a device,
each decoding only its own rows.

Counterpart of nlzm_tpu/parallel/mp_dryrun.py. The single-process mesh
(parallel/mesh.py) runs every shard from one process; a multi-host
deployment also crosses process boundaries: process-group
initialisation, per-process feeding (each process parses and uploads
only the payloads of its own rows), collectives, and an ordered write in
which each process saves only its rows and process 0 assembles them.
This module is one such process; spawn() runs N of them on this machine.

The corpus is JAX's (random.Random(4321) words, (2 * world + 1) blocks of
2048 bytes + 17: ragged on purpose), or the file --input names, encoded
wide with the optimal parse at --block-size (default 2048) with a shared
dictionary of --dict-size bytes (default none; the shipping config is
32768 and 32768) by every process; an all-gather checks that every
process holds the same container CRC. Each process then decodes rows
[pid * Bp / world, (pid + 1) * Bp / world) of the Bp blocks padded to a
multiple of the world size (ops/wide_decode.py::decode_wide_blocks, with
the dictionary), all-gathers the per-block produced sizes (the ordered
gather), saves its rows with their global range, and after a barrier
process 0 assembles the bytes (parallel/blocks.py::gathered: the CRC
and every block's size checked), checks them against the input, writes
them to <outdir>/assembled.bin and prints "mp_dryrun ok: ...".

The caller names the backend and the device; nothing switches either by
itself. gloo's collectives take CPU tensors, nccl's CUDA tensors, and
NCCL refuses two ranks on one GPU: two ranks sharing one card run gloo
with --device cuda (the kernels on the card, the sizes through gloo).
--device cuda takes cuda:(pid % device count); with no CUDA device it
fails.

Two processes by hand, on the CPU:

    python -m nlzm_tpu_torch.parallel.mp_dryrun --procs 2 --pid 0 \\
        --init file:///tmp/mp/init --backend gloo --device cpu --outdir /tmp/mp &
    python -m nlzm_tpu_torch.parallel.mp_dryrun --procs 2 --pid 1 \\
        --init file:///tmp/mp/init --backend gloo --device cpu --outdir /tmp/mp

or both at once, without --pid (spawn: a file:// rendezvous in --outdir):

    python -m nlzm_tpu_torch.parallel.mp_dryrun --procs 2 --backend gloo \\
        --device cpu --outdir /tmp/mp

and on a file at the shipping config:

    python -m nlzm_tpu_torch.parallel.mp_dryrun --procs 2 --backend gloo \\
        --device cuda --outdir /tmp/mp --input in.bin --block-size 32768 --dict-size 32768
"""

import argparse
import os
import random
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

BLOCK_SIZE = 2048
TIMEOUT_S = 300.0
OK = "mp_dryrun ok"


def corpus(world: int, block_size: int = BLOCK_SIZE) -> bytes:
    """JAX's deterministic dry-run corpus: (2 * world + 1) * block_size + 17
    bytes of random words, so the last block is short."""
    rng = random.Random(4321)
    words = [bytes(rng.randrange(97, 123) for _ in range(rng.randrange(3, 9)))
             for _ in range(50)]
    data = b" ".join(words[rng.randrange(50)] for _ in range(3 * world * block_size // 5))
    return data[: (2 * world + 1) * block_size + 17]


def _device(name: str, pid: int) -> torch.device:
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"--device {name!r}: 'cuda' or 'cpu'")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("--device cuda: no CUDA device")
    return torch.device("cuda", pid % n)


def _all_gather(t: torch.Tensor) -> list:
    import torch.distributed as dist

    outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, t)
    return outs


def run(pid: int, procs: int, init: str, backend: str, device: str, outdir: str,
        block_size: int = BLOCK_SIZE, timeout: float = TIMEOUT_S, input_path=None,
        dict_size: int = 0) -> None:
    """One process of the dry run (the module docstring)."""
    import torch.distributed as dist

    from ..format.wide import empty_payload
    from ..ops.wide_decode import decode_wide_blocks, dict_tensor
    from ..utils.crc32 import crc32
    from ..utils.shards import shard_rows
    from .blocks import encode_container, gathered, parse_container

    dev = _device(device, pid)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=procs, rank=pid,
                            timeout=timedelta(seconds=timeout))
    try:
        world = dist.get_world_size()
        if world != procs:
            raise RuntimeError(f"world size {world}, expected {procs}")
        coll = dev if backend == "nccl" else torch.device("cpu")  # where collectives run

        def barrier():
            if backend == "nccl":
                dist.barrier(device_ids=[dev.index])
            else:
                dist.barrier()

        data = Path(input_path).read_bytes() if input_path else corpus(world, block_size)
        container = encode_container(data, block_size=block_size, parser="optimal",
                                     profile="wide", dict_size=dict_size)
        crcs = _all_gather(torch.tensor([crc32(container)], dtype=torch.int64, device=coll))
        if len({int(c) for c in crcs}) != 1:
            raise RuntimeError("container bytes differ across processes")

        # per-process feeding: this process cuts out and stages its rows only
        info = parse_container(container)
        n_blocks = len(info.comp_sizes)
        rows = -(-n_blocks // world) * world
        lo, hi = shard_rows(rows, world, pid)
        offs = info.payload_off + np.concatenate([[0], np.cumsum(info.comp_sizes)])
        mine = [container[offs[b] : offs[b + 1]] if b < n_blocks else empty_payload()
                for b in range(lo, hi)]
        depth = [info.total_reads[b] if b < n_blocks else 0 for b in range(lo, hi)]
        out, produced = decode_wide_blocks(mine, info.block_size, info.wide_priors, depth,
                                           dict_tensor(info.dictionary, dev), device=dev)
        # the ordered gather: every process learns every block's byte count
        sizes = torch.cat(_all_gather(produced.to(coll))).cpu()

        # ordered write: each process saves its rows with their global range
        np.savez(os.path.join(outdir, f"part{pid}.npz"), rows=np.asarray([lo, hi]),
                 data=out.cpu().numpy())
        barrier()
        if pid == 0:
            parts = []
            for p in range(world):
                z = np.load(os.path.join(outdir, f"part{p}.npz"))
                parts.append((*(int(x) for x in z["rows"]), z["data"]))
            parts.sort(key=lambda part: part[0])
            if [a for a, _, _ in parts] != [0] + [b for _, b, _ in parts[:-1]]:
                raise RuntimeError("the saved row ranges do not tile the blocks")
            got = gathered([(torch.from_numpy(d), sizes[a:b]) for a, b, d in parts], info)
            if got != data:
                raise RuntimeError("multi-process sharded decode differs from the input")
            Path(outdir, "assembled.bin").write_bytes(got)
            procs_ = f"{world} process" + ("es" if world > 1 else "")
            print(f"{OK}: {procs_} x 1 device ({dev.type}, {backend}), {len(data)} bytes in "
                  f"{n_blocks} blocks of {info.block_size} ({rows} rows), dictionary "
                  f"{len(info.dictionary or b'')} bytes, wide-decoded with per-process feeding "
                  f"+ ordered write", flush=True)
        barrier()
    finally:
        dist.destroy_process_group()


def spawn(procs: int, backend: str, device: str, outdir, timeout: float = TIMEOUT_S,
          input_path=None, block_size: int = BLOCK_SIZE, dict_size: int = 0) -> str:
    """Run ranks 0..procs-1 of this module as child processes on this
    machine (a file:// rendezvous in `outdir`, which holds their logs,
    their parts and assembled.bin) and wait for them, all within
    `timeout` seconds; input_path, block_size and dict_size as run()
    takes them. Returns process 0's ok line; raises RuntimeError if a
    child fails, the line is missing or the time runs out (every child is
    killed then)."""
    from .. import native

    native.load()  # built here once, not by the children at the same time
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    init = out / "init"
    init.unlink(missing_ok=True)
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(root), env.get("PYTHONPATH")) if p)
    env.setdefault("OMP_NUM_THREADS", "1")
    # every rank is on this machine: rendezvous over the loopback device
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    extra = ["--block-size", str(block_size), "--dict-size", str(dict_size)]
    if input_path is not None:
        extra += ["--input", str(Path(input_path).resolve())]
    logs = [out / f"rank{p}.log" for p in range(procs)]
    children = []
    try:
        for p in range(procs):
            with open(logs[p], "w") as log:
                children.append(subprocess.Popen(
                    [sys.executable, "-m", "nlzm_tpu_torch.parallel.mp_dryrun",
                     "--procs", str(procs), "--pid", str(p), "--init", f"file://{init}",
                     "--backend", backend, "--device", device, "--outdir", str(out),
                     "--timeout", str(timeout), *extra],
                    cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for c in children:
            c.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"mp_dryrun: no end within {timeout} s\n" + _tails(logs)) from None
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    failed = [p for p, c in enumerate(children) if c.returncode != 0]
    if failed:
        raise RuntimeError(f"mp_dryrun: ranks {failed} failed\n" + _tails(logs))
    line = [ln for ln in logs[0].read_text().splitlines() if ln.startswith(OK)]
    if not line:
        raise RuntimeError("mp_dryrun: process 0 printed no ok line\n" + _tails(logs))
    return line[0]


def _tails(logs) -> str:
    return "\n".join(f"--- {p.name}\n{p.read_text()[-2000:]}" for p in logs if p.exists())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--pid", type=int, help="this process's rank (omit: spawn every rank)")
    ap.add_argument("--init", help="init_method, file:// or tcp:// (with --pid)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S)
    ap.add_argument("--input", help="the file to encode and decode (default: JAX's corpus)")
    ap.add_argument("--block-size", type=int, default=BLOCK_SIZE)
    ap.add_argument("--dict-size", type=int, default=0, help="shared dictionary bytes")
    args = ap.parse_args(argv)
    if args.pid is None:
        print(spawn(args.procs, args.backend, args.device, args.outdir, args.timeout,
                    args.input, args.block_size, args.dict_size))
        return 0
    if not args.init:
        ap.error("--init is required with --pid")
    os.makedirs(args.outdir, exist_ok=True)
    run(args.pid, args.procs, args.init, args.backend, args.device, args.outdir,
        block_size=args.block_size, timeout=args.timeout, input_path=args.input,
        dict_size=args.dict_size)
    return 0


if __name__ == "__main__":
    sys.exit(main())

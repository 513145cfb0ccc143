"""Start the ranks of a one-host process group as fresh processes.

    results = launch.run_ranks("package.module:function", 2, arg, platform="cpu")

runs `function(*args)` in n processes that form one process group: each is
`python -m curl_tpu_torch.parallel.launch`, with the JAX rendezvous names
(COORDINATOR_ADDRESS=127.0.0.1:<free port>, NUM_PROCESSES, PROCESS_ID) and
LOCAL_RANK in its environment. It joins the group (`distributed.initialize`,
gloo on the CPU; `backend=` sets CURL_DIST_BACKEND, which names another), calls the
function and hands its return value back. `run_processes` starts any
commands the same way, for a command line that joins the group itself.

A rank that exits non-zero, or a run that outlasts its timeout, stops every
rank and raises with that rank's stderr.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

_ROOT = str(Path(__file__).resolve().parents[2])


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, n: int, port: int, path: Sequence[str] = ()) -> dict[str, str]:
    """This process's environment plus the rendezvous of rank `rank` of `n`
    (the JAX names and LOCAL_RANK) and the repository root and `path` on
    PYTHONPATH."""
    env = dict(os.environ)
    env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(n),
               PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT, *path] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def run_processes(commands: Sequence[Sequence[str]], envs: Sequence[dict], timeout: float,
                  cwd: Optional[str] = None) -> list[tuple[str, str]]:
    """Run the commands at once, one per rank, and wait for all of them.
    Returns each rank's (stdout, stderr). A rank that exits non-zero, or
    the run outlasting `timeout` seconds, kills every rank still running
    and raises RuntimeError with the failed rank's stderr."""
    with tempfile.TemporaryDirectory(prefix="curl_ranks_") as tmp:
        outs = [(Path(tmp) / f"{i}.out", Path(tmp) / f"{i}.err") for i in range(len(commands))]
        procs = []
        try:
            for cmd, env, (out, err) in zip(commands, envs, outs):
                with open(out, "w") as fo, open(err, "w") as fe:
                    procs.append(subprocess.Popen(list(cmd), env=env, cwd=cwd, stdout=fo,
                                                  stderr=fe, stdin=subprocess.DEVNULL))
            deadline = time.monotonic() + timeout
            timed_out = False
            while True:
                codes = [p.poll() for p in procs]
                failed = next((i for i, c in enumerate(codes) if c not in (None, 0)), None)
                if failed is not None or None not in codes:
                    break
                if time.monotonic() > deadline:
                    timed_out, failed = True, codes.index(None)
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = [(o.read_text(), e.read_text()) for o, e in outs]
        if failed is not None:
            why = (f"timed out after {timeout:.0f} s" if timed_out
                   else f"exit code {procs[failed].returncode}")
            raise RuntimeError(
                f"rank {failed} of {len(procs)} failed ({why}): {' '.join(commands[failed])}\n"
                f"--- stderr of rank {failed} ---\n{texts[failed][1][-6000:]}")
        return texts


def run_ranks(target: str, n: int, *args, platform: Optional[str] = "cpu",
              backend: Optional[str] = None, timeout: float = 120.0,
              path: Sequence[str] = ()) -> list:
    """`target` ("module:function", importable from the repository root or
    `path`) called with `args` on each of `n` ranks of one process group;
    returns the ranks' return values in rank order. `platform` None puts
    each rank on `cuda:{rank % device_count}`."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="curl_ranks_") as tmp:
        args_file = Path(tmp) / "args.pkl"
        args_file.write_bytes(pickle.dumps(args))
        results = [Path(tmp) / f"result{i}.pkl" for i in range(n)]
        commands = [[sys.executable, "-m", "curl_tpu_torch.parallel.launch", target, str(args_file), str(res),
                     platform or ""] for res in results]
        envs = [rank_env(i, n, port, path) for i in range(n)]
        if backend:
            for env in envs:
                env["CURL_DIST_BACKEND"] = backend
        run_processes(commands, envs, timeout)
        return [pickle.loads(r.read_bytes()) for r in results]


def _main(target: str, args_file: str, result_file: str, platform: str) -> None:
    from curl_tpu_torch.parallel import distributed

    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    args = pickle.loads(Path(args_file).read_bytes())
    distributed.initialize(platform=platform or None)
    try:
        result = fn(*args)
    finally:
        distributed.shutdown()
    Path(result_file).write_bytes(pickle.dumps(result))


if __name__ == "__main__":
    _main(*sys.argv[1:5])

"""Start the ranks of a world as processes and wait for them.

``launch(n, target, args)`` runs ``target(*args)`` in ``n`` processes,
each started as ``python -m sejonggo_torch.parallel.launch`` with
torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR, MASTER_PORT on a free local port), so that each one joins
the group through ``init_distributed()``.  It waits for every rank with
a time limit and checks each exit code: a rank that fails or hangs ends
the whole world (the others are killed, never left to carry on alone)
and ``launch`` raises with the tail of every rank's log.  Each rank's
return value comes back pickled.

``target`` is ``"package.module:function"`` or
``"path/to/file.py:function"`` (a file is loaded under its own name, so
a test file can hold its rank-side code).
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Sequence

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _load(target: str):
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            "_rank_" + os.path.basename(where)[:-3], where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _tail(path: str, n: int = 6000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def launch(n: int, target: str, args: Sequence = (), *, device=None,
           timeout_s: float = 900.0, echo: bool = False) -> list:
    """Run ``target(*args)`` on ``n`` ranks; returns their return values
    in rank order.  ``device`` goes to every rank's ``init_distributed``
    (None: each rank's card, ``parallel.dist``).  The ranks inherit this
    process's environment.  ``echo`` prints each rank's log afterwards,
    every line prefixed with its rank."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="sejonggo_ranks_") as tmp:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f)
        base = dict(os.environ)
        base["PYTHONPATH"] = os.pathsep.join(
            [_PKG_PARENT] + [p for p in [base.get("PYTHONPATH")] if p])
        base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                    WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n))
        procs, logs = [], []
        for rank in range(n):
            logs.append(os.path.join(tmp, f"rank{rank}.log"))
            cmd = [sys.executable, "-m", "sejonggo_torch.parallel.launch",
                   target, tmp, str(timeout_s), str(device or "")]
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL,
                    env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank))))
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = ", ".join(f"rank {r} exited with {codes[r]}"
                                       for r in bad)
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    failed = f"the ranks ran past {timeout_s:.0f} s"
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        if echo or failed:
            out = sys.stdout if not failed else sys.stderr
            for rank, path in enumerate(logs):
                for line in _tail(path, 1 << 20 if not failed else 6000
                                  ).splitlines():
                    print(f"[rank {rank}] {line}", file=out, flush=True)
        if failed:
            raise RuntimeError(f"{target} on {n} ranks: {failed}; the "
                               "others were stopped (their logs above)")
        results = []
        for rank in range(n):
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _rank_main(argv) -> int:
    target, tmp, timeout_s = argv[0], argv[1], float(argv[2])
    from sejonggo_torch.parallel import dist

    rank = dist.init_distributed(device=argv[3] or None, timeout_s=timeout_s)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    result = _load(target)(*args)
    with open(os.path.join(tmp, f"result{rank}.pkl.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(tmp, f"result{rank}.pkl.tmp"),
               os.path.join(tmp, f"result{rank}.pkl"))
    dist.shutdown()
    return 0


if __name__ == "__main__":
    try:
        code = _rank_main(sys.argv[1:])
    except BaseException:           # noqa: BLE001 — report, exit nonzero
        # no clean shutdown: a collective may be stuck; the launcher
        # stops the other ranks
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.exit(code)

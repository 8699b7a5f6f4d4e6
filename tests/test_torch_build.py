"""The kernel build when several processes start together (the ranks of
a multi-card run).

Each process compiles into a directory of its own under the build
directory and moves the finished library into place atomically
(``ops/_build.py``).  Here two processes build at once with
``nvcc_command`` pointed at a stand-in compiler that sleeps, writes half
of its output, sleeps again and writes the rest: both must end with a
complete library (one process's whole output, never a mix or a missing
file), and no private directory is left behind.  A build that deletes
the build directory first loses this race."""
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMPILER = r'''
import os, sys, time
out = sys.argv[1]
pid = os.getpid()
payload = ("BEGIN %d\n" % pid) + "x" * 4096 + ("\nEND %d\n" % pid)
time.sleep(0.4)
with open(out, "w") as f:
    f.write(payload[:2000]); f.flush()
    time.sleep(0.6)
    f.write(payload[2000:])
'''

BUILD_SCRIPT = r'''
import os, sys
from sejonggo_torch.ops import _build
build_dir, compiler = sys.argv[1], sys.argv[2]
_build.BUILD_DIR = build_dir
_build.nvcc_command = lambda out: [sys.executable, compiler, out]
path = _build._build()
with open(path) as f:
    text = f.read()
lines = text.splitlines()
pid = lines[0].split()[1]
assert lines[0] == "BEGIN " + pid and lines[-1] == "END " + pid, text[:80]
assert len(text) == len("BEGIN %s\n" % pid) + 4096 + len("\nEND %s\n" % pid)
print("COMPLETE", path)
'''


def test_two_processes_build_at_once(tmp_path):
    compiler = tmp_path / "fake_nvcc.py"
    compiler.write_text(COMPILER)
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    for _ in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", BUILD_SCRIPT, str(build_dir),
             str(compiler)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env))
        time.sleep(0.2)        # the second starts while the first compiles
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "COMPLETE" in out, out
    assert sorted(os.listdir(build_dir)) == ["libsejonggo_kernels.so"]

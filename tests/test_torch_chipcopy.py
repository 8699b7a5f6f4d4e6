"""The copy of the checkout that goes to the card machine.

``.chiprunignore`` keeps the JAX package's run artifacts under ``runs/``
(~500 MB) out of the copy, all but the files the smoke run reads:
model_291 and the index beside it, the 48 rollout SGFs of the 19x19
corpus (the KGS pretraining phase) and the two pattern files of
runs/patterns_r5 (the michi GTP session).  The copy does not honour "!"
re-inclusion, so the file names every other entry of ``runs/``.  These
tests fail when an entry of ``runs/`` is neither named there nor one of
those files, and when the copy would pass its 256 MiB limit."""
import fnmatch
import os
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[1]
REQUIRED = {"runs/strength_r5b/sp_models/model_291.msgpack",
            "runs/strength_r5b/sp_models/index.json"} | {
    f"runs/full19_r5/corpus/rollout_{r:02d}_{g:03d}.sgf"
    for r in range(2) for g in range(24)} | {
    "runs/patterns_r5/patterns.spat", "runs/patterns_r5/patterns.prob"}
ALWAYS_LEFT_OUT = (".git", "chiprun_out")   # never copied
LIMIT_BYTES = 256 * 2 ** 20


def _patterns():
    lines = (REPO / ".chiprunignore").read_text().splitlines()
    return [ln.strip() for ln in lines
            if ln.strip() and not ln.strip().startswith("#")]


def _matches(parts, pattern):
    """gitignore matching without negation: a pattern with a slash is
    anchored at the root and matched part by part; one without matches
    any single name."""
    pattern = pattern.rstrip("/")
    if "/" not in pattern:
        return any(fnmatch.fnmatchcase(p, pattern) for p in parts)
    pat = pattern.lstrip("/").split("/")
    return len(parts) >= len(pat) and all(
        fnmatch.fnmatchcase(p, q) for p, q in zip(parts, pat))


def _left_out(rel, patterns):
    parts = rel.split("/")
    return parts[0] in ALWAYS_LEFT_OUT or any(
        _matches(parts, pat) for pat in patterns)


def _files(top):
    for root, _, names in os.walk(REPO / top):
        for name in names:
            path = pathlib.Path(root) / name
            yield path.relative_to(REPO).as_posix(), path


def test_only_the_smoke_runs_checkpoint_goes_from_runs():
    patterns = _patterns()
    assert not any(p.startswith("!") for p in patterns)
    sent = {rel for rel, _ in _files("runs") if not _left_out(rel, patterns)}
    assert REQUIRED <= {rel for rel, _ in _files("runs")}
    assert sent == REQUIRED, (
        f"entries of runs/ that would go to the card: "
        f"{sorted(sent - REQUIRED)[:10]}; name them in .chiprunignore")


def test_the_copy_stays_under_its_limit():
    patterns = _patterns()
    total = sum(path.stat().st_size for rel, path in _files(".")
                if not _left_out(rel, patterns)
                and path.is_file())
    assert total < LIMIT_BYTES, f"the copy would hold {total} bytes"

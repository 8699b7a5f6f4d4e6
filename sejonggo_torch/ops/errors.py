"""The kernels' deferred error check.

Every kernel launch ORs its error bit into one persistent int32 word on
its device when one of its loops hits its iteration cap, so a launch
never synchronises the host.  ``check_kernel_errors`` reads the word
once, resets it and raises if any bit was set; the move step calls it
once per move, the smoke run and the card tests after every kernel
phase or call.  A hit cap therefore still ends the run, at most one move
later, and nothing falls back to a plain version.
"""
from __future__ import annotations

import torch

GOSTEP = 1   # gostep hit an N*N+1 iteration cap
FLOOD = 2    # flood hit its N*N+1 iteration cap
_NAMES = {GOSTEP: "gostep", FLOOD: "flood"}

_words: dict = {}


def error_word(device: torch.device) -> torch.Tensor:
    """The (1,) int32 error word of a CUDA device, made zero at first use."""
    key = torch.device(device).index
    if key is None:
        key = torch.cuda.current_device()
    word = _words.get(key)
    if word is None:
        word = torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", key))
        _words[key] = word
    return word


def check_kernel_errors(device=None) -> None:
    """Read and reset the error word of ``device`` (every device that has
    one when None); raise RuntimeError if a kernel hit a cap.  A CPU
    device has no word: nothing to check."""
    if device is not None and torch.device(device).type != "cuda":
        return
    if device is None:
        words = list(_words.values())
    else:
        words = [error_word(device)]
    for word in words:
        bits = int(word.item())
        if bits:
            word.zero_()
            names = [name for bit, name in _NAMES.items() if bits & bit]
            raise RuntimeError(f"CUDA kernel(s) {', '.join(names)} hit an "
                               f"N*N+1 iteration cap (error word {bits:#x} "
                               f"on {word.device})")

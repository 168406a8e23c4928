"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, on the same captures and weights.

Every number is a count of things that differ, held to the limit 0 (an
exact comparison: verdicts, stats and integer state are bit-exact by the
configuration's own rules):

* ``verdicts_off``: packets whose verdict differs, over the last replay
  of each capture in the window;
* ``stats_off``: stats fields that differ, over the same replays;
* ``state_off``: elements of the final carry (flow table, LUT, bucket
  registers, FIFOs, and on the farm the delay lines and engine FIFOs)
  that differ, after the run's last replay;
* ``replays_off``: replays of the window (and of the traced replays)
  whose verdicts and stats, by digest, are not the reference's for
  their capture.
"""

from __future__ import annotations

import json
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference.fenix_ref import STAT_KEYS

LIMITS = {"verdicts_off": 0, "stats_off": 0, "state_off": 0,
          "replays_off": 0}


def stats_json(stats: Dict) -> str:
    """The stats the reference defines, canonically: a missing field
    reads null and so differs."""
    return json.dumps({k: stats.get(k) for k in STAT_KEYS}, sort_keys=True)


def digest(verdict: np.ndarray, stats: Dict) -> Tuple[int, str]:
    return zlib.crc32(np.ascontiguousarray(verdict, np.int32)), \
        stats_json(stats)


def _state_off(carry: Dict[str, Dict[str, torch.Tensor]],
               ref: Dict[str, Dict[str, torch.Tensor]]) -> int:
    off = 0
    for group, tensors in carry.items():
        for k, want in ref[group].items():
            got = tensors.get(k)
            if got is None or tuple(got.shape) != tuple(want.shape):
                off += want.numel()
            else:
                off += int((got.cpu().to(torch.int64)
                            != want.to(torch.int64)).sum())
    return off


def compare(last: Dict[int, Tuple[np.ndarray, Dict]],
            digests: List[Tuple[int, Tuple[int, str]]],
            carry: Tuple[int, Dict], refs: Dict[int, Dict]
            ) -> Tuple[Dict[str, int], List[bool]]:
    """``last``: capture -> (verdicts, stats) of its last replay;
    ``digests``: (capture, digest) of every replay checked; ``carry``:
    (the capture of the run's last replay, its final carry by group);
    ``refs``: capture -> the reference's replay.  Returns the numbers by
    name and, for each digest, whether it differs."""
    nums = {k: 0 for k in LIMITS}
    for k, (verdict, stats) in last.items():
        want = refs[k]["verdict"]
        nums["verdicts_off"] += (len(want) if verdict.shape != want.shape
                                 else int((verdict != want).sum()))
        rs = refs[k]["stats"]
        nums["stats_off"] += sum(stats.get(f) != rs[f] for f in STAT_KEYS)
    ref_digest = {k: digest(r["verdict"], r["stats"])
                  for k, r in refs.items()}
    bad = [d != ref_digest[k] for k, d in digests]
    nums["replays_off"] = sum(bad)
    k_last, groups = carry
    nums["state_off"] = _state_off(groups, refs[k_last]["carry"])
    return nums, bad


def verdict_of(nums: Dict[str, int]) -> bool:
    return all(nums[k] <= lim for k, lim in LIMITS.items())

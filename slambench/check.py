"""The output check: the window's units against the plain reference.

Every unit starts from the seeded weights and a pool sequence, so the
reference (``reference/<name>.py``, named by the configuration file)
follows each pool sequence's first keyframe event once from the seed, and
every unit that ran that sequence is compared with it. A few units, at
positions of the window drawn from the seed, also keep the program's state
just before each sequence's last keyframe event (``record.py``) and after
it; the reference follows that event from the state before and is compared
with the state after. The numbers:

  * ``schedule_mismatches``: sequences whose keyframes differ from the
    reference's schedule (limit 0);
  * ``first_loss_gap``, ``first_abs_rel_gap``: the relative gap
    ``|program - reference| / |reference|`` of the first event's last-step
    total loss and abs_rel (the network in its dtype, the photometric loss
    and two Adam updates from the seed, on the empty map), the largest over
    every unit. Loose: Adam's first update moves every weight by the
    learning rate whatever its gradient's size, so a gradient at rounding
    level takes a step of its own sign, and two runs of the program itself
    part after one update;
  * ``event_loss_gap``, ``event_point_loss_gap``: the relative gap of the
    followed event's last-step total loss and its three3d term (the 3D
    point loss against the map at its full size: the nearest map point by
    the exact search, or the index image's slot), the largest over the kept
    sequences. From the same weights, moments and map the reference reaches
    the last step through the same two updates, so this is tight;
  * ``event_update_gap``: over the tensors the event's updates step, the
    largest gap between the norm of the program's change and the
    reference's, against the reference's norm of that tensor or of the
    median tensor, whichever is larger (tensors whose first-step gradient
    norm is under a thousandth of the median tensor's are left out: Adam
    moves them by rounding alone);
  * ``fusion_decisions_differ``: the frame's pixels that the program and the
    reference fuse differently (merged into another map row, or appended
    and merged), the reference fusing the frame of the program's weights
    after the event into the map before it;
  * ``fusion_point_gap``: over the rows both fused alike, the largest
    distance between the program's point and the reference's, against the
    reference point's distance from the camera;
  * ``masked_commit_changes``: in a batch of sequences, tensors and map
    rows of a sequence whose schedule had ended that changed afterwards
    (limit 0);
  * ``events_missing``: followed events the state of which was not kept
    (limit 0);
  * ``unmoved_leaves``: tensors the reference's first step gives a
    gradient (its norm at least a thousandth of the median tensor's) that
    a kept sequence's final weights hold exactly at their seeded values
    (limit 0): an update that never reached them.

The limits are the cell's (``workloads/<cell>.json``, ``limits``); a
limit of ``null`` leaves that number out of the cell's check.
``control`` puts the reference computed in a lower precision in the
program's place.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import numpy as np
import torch

from slambench.record import followed_events

FIRST = {"first_loss_gap": "total_loss", "first_abs_rel_gap": "abs_rel"}
EVENT = {"event_loss_gap": "total_loss", "event_point_loss_gap": "three3d"}
COMPARED = ("schedule_mismatches", "first_loss_gap", "first_abs_rel_gap", "event_loss_gap",
            "event_point_loss_gap", "event_update_gap", "fusion_decisions_differ",
            "fusion_point_gap", "masked_commit_changes", "events_missing", "unmoved_leaves")
EXACT = ("schedule_mismatches", "masked_commit_changes", "events_missing", "unmoved_leaves")


def reference_module(conf: Dict):
    return importlib.import_module(f"slambench.reference.{conf['reference']}")


def kept_positions(seed: int, pool: int, count: int) -> set:
    """Window positions whose state the check keeps: the first, and
    ``count - 1`` more drawn from the seed among the next ``2 pool``."""
    rng = np.random.default_rng(int(seed) + 1)
    more = rng.choice(np.arange(1, 2 * pool + 1), size=min(count - 1, 2 * pool), replace=False)
    return {0, *(int(x) for x in more)}


def first_events(conf: Dict, pool: List[Dict], weights, used, quant=None) -> Dict:
    """The reference's first event of every sequence of the pool units
    ``used``: {(unit, sequence): ``first_event``'s result}."""
    ref = reference_module(conf)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for u in sorted(used):
        p = pool[u]
        for i in range(p["colors"].shape[0]):
            out[(u, i)] = ref.first_event(conf["config"], weights, p["colors"][i],
                                          p["depths"][i], p["K"][i], p["poses"][i], quant=quant)
    return out


def rel_gap(p: float, r: float) -> float:
    if r == 0.0:
        return 0.0 if p == 0.0 else float("inf")
    return abs(p - r) / abs(r)


def gaps(runs, refs: Dict) -> Dict[str, float]:
    """The schedule and first-event numbers; ``runs``: [(pool unit, [per
    sequence {"keyframes", "first"}])]."""
    out = {n: 0.0 for n in FIRST}
    out["schedule_mismatches"] = 0
    for u, seqs in runs:
        for i, s in enumerate(seqs):
            r = refs[(u, i)]
            if s["keyframes"] != [c for _, c in r["schedule"]]:
                out["schedule_mismatches"] += 1
                continue
            for n, field in FIRST.items():
                out[n] = max(out[n], rel_gap(s["first"][field], r["row"][field]))
    return out


def update_gap(before: Dict, cand: Dict, ref: Dict, grad_norms: Dict, b: int) -> float:
    """``event_update_gap`` of sequence ``b``: ``before``, ``cand`` (the
    program's or the control's) and ``ref`` stacked weights."""
    med_g = float(np.median(list(grad_norms.values())))
    keys = [k for k, g in grad_norms.items() if g >= 1e-3 * med_g]
    def norms(w):
        return {k: float((w[k][b].detach().double() - before[k][b].double()).norm())
                for k in keys}

    dc, dr = norms(cand), norms(ref)
    med = float(np.median(list(dr.values())))
    return max(abs(dc[k] - dr[k]) / max(dr[k], med, 1e-30) for k in keys)


def fusion_numbers(ref_mod, before: Dict, cand: Dict, ref: Dict, pose: torch.Tensor,
                   K: torch.Tensor, H: int, W: int) -> tuple:
    """(pixels fused differently, largest relative point gap over the rows
    fused alike) of a map ``cand`` (``data``, ``count``) against the
    reference's fusion ``ref`` of the same frame into ``before``."""
    cb, cc = int(before["count"]), int(cand["count"])
    data = cand["data"]
    merged = data[:cb, 9] != before["data"][:cb, 9]
    differ = int((merged ^ ref["merged"]).sum())
    centre = pose[:3, 3]

    def rel(p, r):
        if p.shape[0] == 0:
            return 0.0
        return float(((p.double() - r.double()).norm(dim=-1)
                      / (r.double() - centre.double()).norm(dim=-1)).max())

    both = merged & ref["merged"]
    gap = rel(data[:cb][both, 0:3], ref["data"][:cb][both, 0:3])
    pix, inside = ref_mod.project(data[cb:cc, 0:3], pose, K, H, W)
    rows = torch.arange(cb, cc, device=data.device)[inside]
    pix = pix[inside]
    differ += int((~inside).sum())
    hist_c = torch.bincount(pix, minlength=H * W)
    hist_r = torch.bincount(ref["appended"], minlength=H * W)
    differ += int((hist_c - hist_r).abs().sum())
    row_c = torch.full((H * W,), -1, dtype=torch.long, device=data.device)
    row_c[pix] = rows
    row_r = torch.full((H * W,), -1, dtype=torch.long, device=data.device)
    row_r[ref["appended"]] = torch.arange(ref["appended"].shape[0], device=data.device) + cb
    one = ((hist_c == 1) & (hist_r == 1)).nonzero()[:, 0]
    gap = max(gap, rel(data[row_c[one], 0:3], ref["data"][row_r[one], 0:3]))
    return differ, gap


def _window(p: Dict, b: int, pair) -> tuple:
    idx = list(pair)
    return p["colors"][b][idx], p["depths"][b][idx], p["poses"][b][idx]


def event_check(conf: Dict, pool: List[Dict], units: List[Dict], quant=None) -> Dict:
    """The followed-event numbers over the kept units. With ``quant`` the
    control's: the reference with its convolutions in that precision, from
    the same states, in the program's place."""
    ref = reference_module(conf)
    cfg = conf["config"]
    out = {n: 0.0 for n in EVENT}
    out.update(event_update_gap=0.0, fusion_decisions_differ=0, fusion_point_gap=0.0,
               masked_commit_changes=0, events_missing=0, events_followed=0)
    thr = float(cfg["DEMO"]["frame_threshold"])
    for x in units:
        kept = x.get("kept")
        if not kept:
            continue
        p = pool[x["pool_unit"]]
        counts, snaps = kept["counts"], kept["snaps"]
        final = kept["final"]()
        E = max(counts)
        B = len(counts)
        H, W = p["colors"].shape[2:4]
        schedules = [ref.keyframe_schedule(p["poses"][b].cpu().numpy(), thr) for b in range(B)]
        for e in followed_events(counts):
            if e not in snaps or (e + 1 < E and e + 1 not in snaps):
                out["events_missing"] += 1
                continue
            before, after = snaps[e], (snaps[e + 1] if e + 1 < E else final)
            active = [e < c for c in counts]
            pairs = [schedules[b][min(e, counts[b] - 1)] for b in range(B)]
            win = [_window(p, b, pairs[b]) for b in range(B)]
            frames, gts, poses = (torch.stack([w[i] for w in win]) for i in range(3))
            r = ref.follow_event(cfg, before, frames, gts, p["K"], poses, active)
            depth = ref.fused_depth(cfg, after["weights"], frames, gts)
            if quant is not None:
                c = ref.follow_event(cfg, before, frames, gts, p["K"], poses, active, quant=quant)
                c_rows, c_weights = c["rows"], c["weights"]
                c_depth = ref.fused_depth(cfg, after["weights"], frames, gts, quant=quant)
            else:
                c_rows = [x["sequences"][b]["metrics"][e] if active[b] else None
                          for b in range(B)]
                c_weights = after["weights"]
            for b in range(B):
                if not active[b]:
                    continue
                out["events_followed"] += 1
                for n, field in EVENT.items():
                    out[n] = max(out[n], rel_gap(c_rows[b][field], r["rows"][b][field]))
                out["event_update_gap"] = max(out["event_update_gap"], update_gap(
                    before["weights"], c_weights, r["weights"], r["grad_norms"][b], b))
                pose = poses[b][1]
                fused = ref.fuse(cfg, before["maps"][b], depth[b], frames[b][1], p["K"][b], pose)
                cand = after["maps"][b]
                if quant is not None:
                    cand = ref.fuse(cfg, before["maps"][b], c_depth[b], frames[b][1], p["K"][b],
                                    pose)
                d, g = fusion_numbers(ref, before["maps"][b], cand, fused, pose, p["K"][b], H, W)
                out["fusion_decisions_differ"] += d
                out["fusion_point_gap"] = max(out["fusion_point_gap"], g)
        if quant is None:
            out["masked_commit_changes"] += masked_changes(counts, snaps, final)
    return out


def masked_changes(counts: List[int], snaps: Dict, final: Dict) -> int:
    """Tensors and map rows of each sequence whose schedule ended before
    the run's last event that differ between the state after its last
    event and the run's final state."""
    E, n = max(counts), 0
    for b, c in enumerate(counts):
        if c >= E or c not in snaps:
            continue
        was = snaps[c]
        n += sum(not torch.equal(was["weights"][k][b], final["weights"][k][b])
                 for k in was["weights"])
        m0, m1 = was["maps"][b], final["maps"][b]
        n += int((m0["data"] != m1["data"]).any(dim=1).sum())
        n += int(int(m0["count"]) != int(m1["count"]))
    return n


def unmoved(weights: Dict, units: List[Dict], refs: Dict) -> int:
    """``unmoved_leaves`` over the kept sequences of ``units``."""
    count = 0
    for x in units:
        kept = x.get("kept")
        if not kept:
            continue
        final = kept["final"]()
        for i in range(len(kept["counts"])):
            norms = refs[(x["pool_unit"], i)]["first_grad_norms"]
            floor = 1e-3 * float(np.median(list(norms.values())))
            count += sum(1 for k, n in norms.items()
                         if n >= floor and torch.equal(final["weights"][k][i], weights[k]))
    return count


def limits_of(cell: Dict) -> Dict[str, Optional[float]]:
    return dict(cell["limits"], **{n: 0 for n in EXACT})


def compare(cell: Dict, conf: Dict, pool: List[Dict], weights, units: List[Dict]) -> Dict:
    """Each compared number of the window's ``units`` beside its limit."""
    refs = first_events(conf, pool, weights, {x["pool_unit"] for x in units})
    values = gaps([(x["pool_unit"], x["sequences"]) for x in units], refs)
    values.update(event_check(conf, pool, units))
    values["unmoved_leaves"] = unmoved(weights, units, refs)
    limits = limits_of(cell)
    return {n: {"value": values[n], "limit": limits[n]} for n in COMPARED
            if limits.get(n) is not None}


def control(conf: Dict, pool: List[Dict], weights, kind: str, refs: Dict,
            units: List[Dict]) -> Dict[str, float]:
    """The numbers of the reference computed with its convolutions in the
    lower precision ``kind`` (``reference.CONTROLS``) put in the program's
    place: its first event from the seed on the pool units of ``refs``,
    and the followed events from the kept units' states."""
    quant = reference_module(conf).CONTROLS[kind]
    used = sorted({u for u, _ in refs})
    low = first_events(conf, pool, weights, used, quant=quant)
    runs = [(u, [{"keyframes": [c for _, c in low[(u, i)]["schedule"]], "first": low[(u, i)]["row"]}
                 for i in range(pool[u]["colors"].shape[0])]) for u in used]
    out = gaps(runs, refs)
    out.update(event_check(conf, pool, units, quant=quant))
    return out

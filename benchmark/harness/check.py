"""Judge what the window served against the plain float32 reference.

Numbers compared (each printed beside its limit):

* ``t2s_gap``: over every position of the judged greedy requests, the widest
  gap by which the served code's reference logit lies below the reference's
  best, after the penalty and masks greedy decoding applies there.  The
  reference reads the program's phonemes, prompt codes and served codes
  (teacher forcing): the phonemes come from the program's frontend, which
  no number here judges, and the prompt codes from its featurizers, which
  ``prompt_code_mismatch`` judges.
* ``t2s_flip_share``: the share of those positions where the served code is
  not the reference's best.
* the SoVITS stage's numbers (v2's ``sovits_spec``, ``sovits_err``) come from
  the configuration's family module, ``families/<sovits_family>.py``.
* ``prompt_code_gap``: over every judged voice's prompt frames, the widest
  relative excess of the chosen code's squared distance (HuBERT →
  ``ssl_proj`` → the codebook) over the nearest code's, under the
  reference; ``prompt_code_gap_mean``, that excess averaged over all those
  frames; ``prompt_code_mismatch``, the share of those frames whose code
  differs.
* ``sv_emb_err`` (v2Pro): relative L2 distance of the ERes2NetV2
  embedding from the reference's.

The control puts the reference in the program's place with every matrix
rounded to float8 e4m3 (one scale a row), the precision step below the
configuration's bfloat16, and reads the same numbers from it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def fp8_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale a row (dim 0)."""
    flat = t.float().reshape(t.shape[0], -1)
    scale = flat.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 448.0
    q = (flat / scale).to(torch.float8_e4m3fn).float() * scale
    return q.reshape(t.shape)


def select(items: List[dict], k: int, rng: np.random.RandomState) -> List[dict]:
    """The longest judged request and a seeded sample of the rest."""
    if len(items) <= k:
        return list(items)
    longest = max(range(len(items)), key=lambda i: sum(len(g["served"]) for g in items[i]["gen"]))
    rest = [i for i in range(len(items)) if i != longest]
    pick = [longest] + list(rng.choice(rest, size=k - 1, replace=False))
    return [items[i] for i in sorted(pick)]


def fed_codes(g: dict, tok0: int, s_max: int, eos: int) -> np.ndarray:
    """The codes the program fed after the prompt, in order: the prefill's
    code (which no entry point serves), the served codes, and the EOS it
    sampled when it ended before the cache's edge."""
    fed = [tok0] + list(g["served"])
    if len(g["x"]) + len(g["y"]) + len(fed) < s_max:
        fed.append(eos)
    return np.asarray(fed, np.int64)


def t2s_gaps(ref, gens: List[dict], sample: dict, s_max: int, ctl_ref=None) -> Dict[str, float]:
    """Widest gap of the served codes (and, with ``ctl_ref``, of the codes
    the control puts first at the same positions) under ``ref``."""
    from reference.t2s import masks_for

    worst, worst_ctl, n_pos, flips, flips_ctl = 0.0, 0.0, 0, 0, 0
    for g in gens:
        kw = dict(prompt_codes=g["y"], eos=ref.eos, suppressed=sample["suppressed"],
                  penalty=sample["penalty"], suppress_until=sample["suppress_until"])
        if g.get("tok0"):
            firsts = g["tok0"][:1]
        else:  # the prefill's code was not recorded: the reference's two best there
            row0 = masks_for(ref.logits(g["x"], g["y"], g["bert"], 1), fed=[], **kw)[0]
            firsts = [int(t) for t in row0.topk(2).indices]
        best_try = None
        for tok0 in firsts:
            fed = fed_codes(g, tok0, s_max, ref.eos)
            y_all = np.concatenate([g["y"], fed[:-1]])
            lg = masks_for(ref.logits(g["x"], y_all, g["bert"], len(fed)), fed=fed, **kw)
            best = lg.max(dim=1).values
            got = lg[torch.arange(len(fed)), torch.as_tensor(fed, device=lg.device)]
            gap = float((best - got).max())
            if best_try is None or gap < best_try[0]:
                best_try = (gap, fed, y_all, lg, best)
        gap, fed, y_all, lg, best = best_try
        worst = max(worst, gap)
        n_pos += len(fed)
        ref_top = lg.argmax(dim=1)
        flips += int((ref_top != torch.as_tensor(fed, device=lg.device)).sum())
        if ctl_ref is not None:
            lc = masks_for(ctl_ref.logits(g["x"], y_all, g["bert"], len(fed)), fed=fed, **kw)
            pick = lc.argmax(dim=1)
            worst_ctl = max(worst_ctl, float((best - lg[torch.arange(len(fed)), pick]).max()))
            flips_ctl += int((pick != ref_top).sum())
    out = {"t2s_gap": worst, "t2s_positions": n_pos,
           "t2s_flip_share": flips / n_pos if n_pos else 0.0}
    if ctl_ref is not None:
        out["t2s_gap"] = worst_ctl
        out["t2s_flip_share"] = flips_ctl / n_pos if n_pos else 0.0
    return out


def rel(a: np.ndarray, b: np.ndarray) -> float:
    n = min(len(a), len(b))
    a, b = np.asarray(a[:n], np.float64), np.asarray(b[:n], np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def voice_numbers(vref, voices: List[dict], ctl=None) -> Dict[str, float]:
    """``prompt_code_gap``, ``prompt_code_gap_mean``, ``prompt_code_mismatch``
    and, where the program made one, ``sv_emb_err``, over ``voices``: the
    program's prompt codes (and embedding) per clip.  ``vref`` is the
    family's reference, which featurizes the clips.  With ``ctl`` (a
    reference in the control's precision) the control's numbers against
    ``vref``."""
    out: Dict[str, float] = {}
    frames = differ = 0
    excess_sum = 0.0
    for v in voices:
        dist = vref.prompt_distances(v["prompt_wav"])
        want = dist.argmin(dim=1).cpu().numpy()
        got = ctl.prompt_codes(v["prompt_wav"]) if ctl is not None else np.asarray(v["codes"])
        n = min(len(want), len(got))
        d = dist[:n]
        near = d.min(dim=1).values
        chosen = d[torch.arange(n, device=d.device), torch.as_tensor(got[:n], device=d.device)]
        excess = (chosen - near) / near.clamp_min(1e-12)
        gap = float(excess.max()) if n else 0.0
        if len(want) != len(got):
            gap = float("inf")  # a code missing or extra: not a near tie
        out["prompt_code_gap"] = max(out.get("prompt_code_gap", 0.0), gap)
        frames += max(len(want), len(got))
        differ += int(np.sum(want[:n] != got[:n])) + abs(len(want) - len(got))
        excess_sum += float(excess.sum())
    if frames:
        out["prompt_code_gap_mean"] = excess_sum / frames
        out["prompt_code_mismatch"] = differ / frames
        if v.get("sv_emb") is not None:
            want_e = vref.sv_embedding(v["spk_wav"]).reshape(-1).cpu().numpy()
            got_e = (ctl.sv_embedding(v["spk_wav"]).reshape(-1).cpu().numpy() if ctl is not None
                     else v["sv_emb"])
            out["sv_emb_err"] = max(out.get("sv_emb_err", 0.0), rel(got_e, want_e))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number that has a limit is at or below it."""
    return all(numbers.get(k) is not None and numbers[k] <= lim for k, lim in limits.items())


def limit_lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"{k} {numbers.get(k)!r} limit {lim!r}" for k, lim in limits.items()]


def checked(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, list]:
    return {k: [numbers.get(k), lim] for k, lim in limits.items()}


"""Random weights from the seed, written where the program's loaders read them.

Each model part of a configuration names a leaf table under
``benchmark/weights/`` (``tools/make_leaves.py``).  All normal leaves of a
part come from one ``torch.randn`` and all uniform leaves from one
``torch.rand`` of a generator on the card, scaled leaf by leaf there and
stored in the served dtype.  The configuration's ``assumed`` block scales
named leaves and sets the EOS length control; the files go under a
directory the caller owns (the run's ``TMPDIR``), where the table's
``layout`` (or its ``format``'s, in ``FORMATS``) puts them.
"""
from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
_ST_NAMES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16"}
_ST_DTYPES = {v: k for k, v in _ST_NAMES.items()}
#: where each named ``format`` of a leaf table is written, as the program's
#: loaders read a ``models_dir``: a layout's ``dir`` and ``file`` under the
#: root, the ``container`` (``safetensors`` or ``torch``) and, where the
#: loader reads one, the ``meta_file`` holding the table's ``meta``
FORMATS = {
    "gpt_dir": {"dir": "gpt", "file": "model.safetensors", "container": "safetensors",
                "meta_file": "config.json"},
    "sovits_dir": {"dir": "sovits", "file": "model.safetensors", "container": "safetensors",
                   "meta_file": "hps.json"},
    "hubert_dir": {"dir": "chinese-hubert-base", "file": "model.safetensors",
                   "container": "safetensors", "meta_file": "config.json"},
    "sv_ckpt": {"dir": "sv", "file": "pretrained_eres2netv2w24s4ep4.ckpt",
                "container": "torch", "meta_file": None},
}
CONTAINERS = ("safetensors", "torch")


def leaf_table(part: str, root: Path = HERE) -> dict:
    return json.loads((root / "weights" / f"{part}.json").read_text())


def layout(table: dict, part: str) -> dict:
    """The table's own ``layout``, else its ``format``'s.  A table with
    neither, a container not in ``CONTAINERS``, or a ``dir`` or ``file``
    that is not a plain relative path raises."""
    lay = table.get("layout") or FORMATS.get(table.get("format"))
    if lay is None:
        raise ValueError(f"leaf table {part!r} has no layout and no known format "
                         f"({table.get('format')!r}; known: {', '.join(FORMATS)})")
    names = [lay.get("dir"), lay.get("file")] + ([lay["meta_file"]] if lay.get("meta_file")
                                                 else [])
    if lay.get("container") not in CONTAINERS or not all(
            isinstance(n, str) and n and not Path(n).is_absolute() and ".." not in Path(n).parts
            for n in names):
        raise ValueError(f"leaf table {part!r}: a layout needs a relative dir and file and a "
                         f"container of {CONTAINERS}, not {lay!r}")
    return lay


def write_part(sd: Dict[str, torch.Tensor], table: dict, lay: dict, root: Path) -> Path:
    """One part's file (and its meta file) under ``root``.  Returns the
    part's path as the program's loaders take it: the directory of a part
    with a meta file (a model directory), else the file."""
    d = root / lay["dir"]
    d.mkdir(parents=True, exist_ok=True)
    p = d / lay["file"]
    if lay["container"] == "torch":
        torch.save({k: v.cpu() for k, v in sd.items()}, str(p))
    else:
        save_safetensors(sd, p)
    if lay.get("meta_file"):
        (d / lay["meta_file"]).write_text(json.dumps(table["meta"]))
        return d
    return p


def draw_part(table: dict, gen: torch.Generator, device, dtype) -> Dict[str, torch.Tensor]:
    """Every leaf of one part: two large draws, then a scale per leaf."""
    leaves = table["leaves"]
    n_norm = sum(math.prod(s) for _, s, kind, *_ in leaves if kind == "n")
    n_unif = sum(math.prod(s) for _, s, kind, *_ in leaves if kind == "u")
    normal = torch.randn(n_norm, generator=gen, device=device, dtype=torch.float32)
    unif = torch.rand(max(n_unif, 1), generator=gen, device=device, dtype=torch.float32)
    out, i_n, i_u = {}, 0, 0
    for name, shape, kind, *arg in leaves:
        n = math.prod(shape)
        if kind == "n":
            t = normal[i_n:i_n + n].mul(arg[1]).add_(arg[0])
            i_n += n
        elif kind == "u":
            t = unif[i_u:i_u + n].mul(arg[1] - arg[0]).add_(arg[0])
            i_u += n
        else:
            t = torch.full((n,), float(arg[0]), device=device)
        out[name] = t.reshape(shape).to(dtype)
    return out


def t2s_shaping(sd: Dict[str, torch.Tensor], meta: dict, spec: dict):
    """Keep a random post-norm stack from collapsing: at the drawn scales
    every position's last hidden state converges to one vector (a ReLU
    branch's mean and near-uniform attention add the same vector to every
    row, layer after layer), so the logits ignore the context.  Each block's
    attention and MLP outputs are scaled by ``attn_out`` and ``mlp_out``,
    and its query and key rows by ``qk_gain``, so attention picks among
    keys and each step's logits follow what was fed."""
    m = meta["model"]
    D = m["hidden_dim"]
    for i in range(m["n_layer"]):
        pfx = f"t2s_transformer.blocks.{i}."
        for key, factor in (("out_proj.weight", spec["attn_out"]),
                            ("mlp.2.weight", spec["mlp_out"])):
            sd[pfx + key] = (sd[pfx + key].float() * factor).to(sd[pfx + key].dtype)
        w = sd[pfx + "qkv.weight"]
        w[:2 * D] = (w[:2 * D].float() * spec["qk_gain"]).to(w.dtype)


def eos_control(sd: Dict[str, torch.Tensor], meta: dict, ctl: dict, gen: torch.Generator):
    """The length control.  A unit vector u and a probe prompt come from the
    seed; the reference decoder (float32) reads, over the probe's code
    positions (random codes, then the codes it puts first there fed back), the mean μ and spread σ of h·u (h the last block's output)
    and the mean M of the best other code's logit.  The last block's
    post-norm bias then gains b·u and the head's EOS row becomes
    (gain/σ)·u, with b set so that EOS's logit is M + delta +
    gain·(h·u − μ)/σ: about M + delta + gain·N(0, 1) at every step, a fixed
    distance below the best code whatever the seed, so requests end at the
    model's own EOS with a hazard that does not depend on the seed.
    Returns (μ, σ, M)."""
    import sys

    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    from reference.t2s import T2SReference

    m = meta["model"]
    D, L, eos = m["hidden_dim"], m["n_layer"], m["EOS"]
    dev = sd["ar_predict_layer.weight"].device
    u = torch.randn(D, generator=gen, device=dev, dtype=torch.float32)
    u = u / u.norm()
    n_x, n_y = 100, 300
    x = torch.randint(1, m["phoneme_vocab_size"], (n_x,), generator=gen, device=dev)
    y = torch.randint(0, eos, (n_y,), generator=gen, device=dev)
    ref = T2SReference(sd, meta, dev)
    xs, bert = x.cpu().numpy(), np.zeros((n_x, 1024), np.float32)
    h = ref.hidden(xs, y.cpu().numpy(), bert)[n_x:]
    # the codes the model itself puts first, fed back once: contexts nearer
    # to those it meets while decoding than random codes are
    y2 = torch.cat([y[:1], (h @ ref.head[:eos].T).argmax(dim=1)[:-1]])
    h = ref.hidden(xs, y2.cpu().numpy(), bert)[n_x:]
    proj = h @ u
    mu, sigma = float(proj.mean()), float(proj.std().clamp_min(1e-3))
    best = float((h @ ref.head[:eos].T).max(dim=1).values.mean())
    del ref
    gain = ctl["gain"]
    b = (best + ctl["delta"]) * sigma / gain - mu
    key = f"t2s_transformer.blocks.{L - 1}.norm2.bias"
    dt = sd[key].dtype
    sd[key] = (sd[key].float() + b * u).to(dt)
    sd["ar_predict_layer.weight"][eos] = (gain / sigma * u).to(dt)
    return mu, sigma, best


def save_safetensors(tensors: Dict[str, torch.Tensor], path: Path):
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)


def load_safetensors(path: Path) -> Dict[str, torch.Tensor]:
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _ST_DTYPES[info["dtype"]]
        b, e = info["data_offsets"]
        buf = bytearray(data[b:e])
        t = torch.frombuffer(buf, dtype=torch.int16 if dt == torch.bfloat16 else dt)
        out[name] = (t.view(torch.bfloat16) if dt == torch.bfloat16 else t).reshape(
            info["shape"])
    return out


def write_models(cfg: dict, seed: int, root: Path, device, dtype=torch.bfloat16,
                 tables: Path = HERE) -> dict:
    """The configuration's parts under ``root``, laid out as a ``models_dir``
    (``chinese-hubert-base/``, ``sv/``) beside the GPT and SoVITS
    directories, from the leaf tables under ``tables``.  Every part comes
    from ``seed`` but those the configuration's ``fixed_parts`` names, which
    come from its ``weights_seed``: the parts that decide how long the
    outputs run (the t2s decoder, and where prompts are featurized in the
    window the HuBERT and the SoVITS quantizer that make its prompt codes),
    since the lengths are the work a run does and have to be the same for
    every seed.  Returns the paths."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    assumed = cfg.get("assumed", {})
    scal = assumed.get("scalings", {})
    paths = {}
    tabs = {role: leaf_table(part, tables) for role, part in cfg["parts"].items()}
    lays = {role: layout(tabs[role], cfg["parts"][role]) for role in tabs}
    for role, table in tabs.items():
        g = gen
        if role in assumed.get("fixed_parts", ("gpt",)):  # the same for every seed
            g = torch.Generator(device=device)
            g.manual_seed(int(assumed["weights_seed"]) + list(cfg["parts"]).index(role))
        sd = draw_part(table, g, device, dtype)
        for name, factor in scal.get(role, {}).items():
            sd[name] = (sd[name].float() * factor).to(dtype)
        if role == "gpt":
            t2s_shaping(sd, table["meta"], assumed["t2s_shaping"])
            paths["eos_probe"] = eos_control(sd, table["meta"], assumed["eos_control"], g)
        paths[role] = write_part(sd, table, lays[role], root)
        del sd
    for sub in ("g2p", "sv"):  # present, so nothing is fetched
        (root / sub).mkdir(exist_ok=True)
    return paths


def sine_voice(seconds: float, freq: float, rng: np.random.RandomState, sr: int = 32000):
    """A seeded voice-like clip: a tone with a 3 Hz tremolo and noise."""
    t = np.arange(int(sr * seconds)) / sr
    wav = 0.3 * np.sin(2 * np.pi * freq * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (wav + 0.02 * rng.randn(len(t))).astype(np.float32)


def save_wav(path: Path, audio: np.ndarray, sr: int = 32000):
    """16-bit PCM mono WAV."""
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)

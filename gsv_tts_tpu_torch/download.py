"""Pretrained-asset download manager (reference ``gsv_tts/Download.py``).

Races Hugging Face vs ModelScope by HEAD-request latency, fetches the
pretrained bundle zips (hubert / g2p / sv) and the full-precision BERT, with
size-verified downloads and zip extraction.  Network use is entirely optional
— every caller degrades gracefully when the assets are already on disk or the
environment is offline (``GSV_OFFLINE=1`` skips all probing)."""
from __future__ import annotations

import logging
import os
import time
import zipfile
from pathlib import Path
from typing import Optional

MODELSCOPE_BASE_URL = "https://modelscope.cn/models/chinokiki/GPTSoVITS-RT/resolve/master/%s"
HUGGINGFACE_BASE_URL = "https://huggingface.co/cnmds/GPTSoVITS-RT/resolve/main/%s?download=true"
G2P_RELEASE_URL = "https://github.com/chinokikiss/GSV-TTS-Lite/releases/download/g2p/%s"

#: per-read socket timeout for asset downloads: a stalled connection must
#: fail (and be retried / degraded) instead of hanging TTS() init forever
DOWNLOAD_TIMEOUT_S = 30.0

_base_url: Optional[str] = None


def _offline() -> bool:
    return bool(os.environ.get("GSV_OFFLINE"))


def download_file(url: str, filename) -> bool:
    import requests
    from tqdm import tqdm

    logging.info(f"Downloading model from {url}")
    response = requests.get(url, stream=True, timeout=DOWNLOAD_TIMEOUT_S)
    # a 404/403 error page must not be saved as the asset (its body's
    # length matches its own content-length, so the size check passes and
    # the corruption only surfaces later as a confusing BadZipFile)
    response.raise_for_status()
    total = int(response.headers.get("content-length", 0))
    bar = tqdm(total=total, unit="iB", unit_scale=True)
    with open(filename, "wb") as f:
        for data in response.iter_content(1024 * 64):
            bar.update(len(data))
            f.write(data)
    bar.close()
    if total != 0 and bar.n != total:
        logging.error(
            f"Download of {filename} incomplete: expected {total} bytes, got {bar.n}.")
        return False
    logging.info(f"Download complete: {filename}")
    return True


def unzip_file(zip_filepath, extract_to):
    logging.info(f"Extracting {zip_filepath}...")
    with zipfile.ZipFile(zip_filepath, "r") as z:
        z.extractall(extract_to)
    logging.info(f"Extraction complete: {extract_to}")


def check_latency(url: str, timeout: float = 3.0):
    import requests

    try:
        t0 = time.time()
        r = requests.head(url, timeout=timeout, allow_redirects=True)
        if r.status_code == 405:
            r = requests.get(url, timeout=timeout, stream=True)
            r.close()
        if 200 <= r.status_code < 400:
            return True, (time.time() - t0) * 1000
        return False, float("inf")
    except Exception:
        return False, float("inf")


def get_base_url() -> str:
    """HF-vs-ModelScope latency race (reference ``Download.py:63-87``) —
    the two probes run CONCURRENTLY, so the cold-start probe phase is
    bounded by max(latency, timeout), not the sum."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as ex:
        hf = ex.submit(check_latency, "https://huggingface.co", 5)
        ms = ex.submit(check_latency, "https://www.modelscope.cn", 5)
        hf_ok, hf_lat = hf.result()
        ms_ok, ms_lat = ms.result()
    if ms_ok and not hf_ok:
        return MODELSCOPE_BASE_URL
    if hf_ok and not ms_ok:
        return HUGGINGFACE_BASE_URL
    if not hf_ok and not ms_ok:
        logging.error("Both Hugging Face and ModelScope unreachable; defaulting to HF.")
        return HUGGINGFACE_BASE_URL
    return MODELSCOPE_BASE_URL if ms_lat < hf_lat else HUGGINGFACE_BASE_URL


def download_model(filename: str, dir, download_url: Optional[str] = None):
    global _base_url
    if download_url is None:
        if _base_url is None:
            _base_url = get_base_url()
        download_url = _base_url
    url = download_url % filename
    zip_path = Path(dir) / filename
    try:
        if download_file(url, zip_path):
            unzip_file(zip_path, os.path.dirname(zip_path))
    finally:
        # never leave a partial/corrupt multi-hundred-MB zip behind —
        # failed startups would otherwise accumulate dead files in
        # ~/.cache/gsv with nothing cleaning them up
        if zip_path.exists():
            os.remove(zip_path)


def check_pretrained_models(models_dir) -> bool:
    """Ensure the hubert/g2p/sv bundle exists; download when missing and the
    environment permits.  Returns True when all assets are present."""
    models_dir = Path(models_dir)
    required = [models_dir / "chinese-hubert-base", models_dir / "g2p",
                models_dir / "sv"]
    missing = [p for p in required if not p.exists()]
    if not missing:
        return True
    if _offline():
        logging.warning(
            f"Missing pretrained assets {', '.join(str(p) for p in missing)} "
            "and GSV_OFFLINE is set; features depending on them will be gated.")
        return False
    global _base_url
    if _base_url is None:
        _base_url = get_base_url()
    os.makedirs(models_dir, exist_ok=True)
    try:
        if _base_url == MODELSCOPE_BASE_URL:
            download_model("pretrained_models5.zip", models_dir)
        else:
            download_model("pretrained_models6.zip", models_dir)
            download_model("g2p.zip", models_dir, download_url=G2P_RELEASE_URL)
    except Exception as e:  # noqa: BLE001
        logging.error(f"Pretrained download failed ({e}); continuing with "
                      "locally available assets only.")
        return False
    return all(p.exists() for p in required)


def download_bert(models_dir) -> bool:
    """Fetch the full-precision chinese-roberta (reference downloads either
    this zip on GPU or the INT8 ONNX on CPU, ``TTS.py:125-129``; the JAX
    engine always uses the full checkpoint).  Called by ``TTS._load_bert``
    when the BERT dir is missing and the environment is online."""
    if _offline():
        return False
    try:
        download_model("chinese-roberta.zip", models_dir)
    except Exception as e:  # noqa: BLE001 — degrade like the bundle path
        logging.error(f"BERT download failed ({e}); Chinese prosody "
                      "features will be zero-filled.")
        return False
    return True

"""The port's download manager (``download.py``, a verbatim copy of the JAX
package's) and the facade's two calls of it: ``TTS()`` fetching the
pretrained bundle into an empty ``models_dir`` and ``_load_bert`` fetching
the BERT zip.  A loopback HTTP server stands in for the hosts; the module
globals that name them are pointed at it, so nothing leaves the machine."""
import io
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from test_torch_assets import text_modules_as_installed  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


class _AssetHandler(BaseHTTPRequestHandler):
    """Serves ``server.files``; records every request's method and path."""

    def log_message(self, *a):
        pass

    def _body(self):
        self.server.seen.append((self.command, self.path))
        return self.server.files.get(self.path.split("?")[0].lstrip("/"))

    def do_HEAD(self):
        body = self._body()
        self.send_response(200 if body is not None else 404)
        self.end_headers()

    def do_GET(self):
        body = self._body()
        if body is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture()
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _AssetHandler)
    srv.files, srv.seen = {}, []
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv
    finally:
        srv.shutdown()
        t.join(timeout=5)


def url(srv, template="%s"):
    return f"http://127.0.0.1:{srv.server_address[1]}/" + template


def zip_bytes(entries):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, data in entries.items():
            z.writestr(name, data)
    return buf.getvalue()


def tree(root: Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.fixture()
def online(monkeypatch, server):
    """Both packages' download modules online and aimed at the loopback
    server (the Hugging Face flavour: bundle 6, then the G2P release)."""
    from gsv_tts_tpu import download as jdl
    from gsv_tts_tpu_torch import download as pdl

    monkeypatch.delenv("GSV_OFFLINE", raising=False)  # tests/conftest.py sets it
    for dl in (jdl, pdl):
        monkeypatch.setattr(dl, "_base_url", url(server))
        monkeypatch.setattr(dl, "G2P_RELEASE_URL", url(server, "release/%s"))
    server.files["pretrained_models6.zip"] = zip_bytes({
        "chinese-hubert-base/config.json": b"{}",
        "sv/pretrained_eres2netv2w24s4ep4.ckpt": b"ckpt"})
    server.files["release/g2p.zip"] = zip_bytes({"g2p/zh/pinyin.txt": b"a\ta1\n"})
    return pdl, jdl


def test_download_module_is_a_verbatim_copy():
    assert (REPO / "gsv_tts_tpu_torch" / "download.py").read_bytes() == \
        (REPO / "gsv_tts_tpu" / "download.py").read_bytes()


def test_tts_fetches_the_bundle_as_jax(online, server, tmp_path):
    """``TTS(device="cpu")`` on an empty ``models_dir`` fetches the bundle and
    the G2P release into the same tree as JAX's ``check_pretrained_models``,
    and removes the zips."""
    from gsv_tts_tpu_torch import TTS

    pdl, jdl = online
    TTS(models_dir=str(tmp_path / "port"), device="cpu", seed=0)
    assert server.seen == [("GET", "/pretrained_models6.zip"), ("GET", "/release/g2p.zip")]
    assert jdl.check_pretrained_models(tmp_path / "jax") is True
    assert len(server.seen) == 4
    got = tree(tmp_path / "port")
    assert got == tree(tmp_path / "jax")
    assert set(got) == {"chinese-hubert-base/config.json", "g2p/zh/pinyin.txt",
                        "sv/pretrained_eres2netv2w24s4ep4.ckpt"}
    # present now: a second facade asks for nothing
    TTS(models_dir=str(tmp_path / "port"), device="cpu", seed=0)
    assert len(server.seen) == 4
    assert pdl.check_pretrained_models(tmp_path / "port") is True


def test_load_bert_fetches_the_bert_zip(online, server, tmp_path):
    """With the bundle present and the BERT directory missing, ``use_bert``
    fetches ``chinese-roberta.zip``, unpacks it and loads the featurizer."""
    from gsv_tts_tpu_torch import TTS
    from test_torch_roberta import write_bert_dir

    src = tmp_path / "bert_src"
    write_bert_dir(src)
    server.files["chinese-roberta.zip"] = zip_bytes({
        f"chinese-roberta-wwm-ext-large/{p.name}": p.read_bytes() for p in src.iterdir()})
    models = tmp_path / "models"
    for name in ("chinese-hubert-base", "g2p", "sv"):
        (models / name).mkdir(parents=True)
    t = TTS(models_dir=str(models), device="cpu", seed=0, use_bert=True)
    assert server.seen == [("GET", "/chinese-roberta.zip")]
    assert t.tts_config.cnroberta is not None and t._bert_loaded
    assert (models / "chinese-roberta-wwm-ext-large" / "config.json").exists()
    assert not (models / "chinese-roberta.zip").exists()
    assert t.tts_config.cnroberta.cfg.hidden_size > 0


def test_offline_sends_no_request(online, server, tmp_path, monkeypatch, caplog):
    """Under ``GSV_OFFLINE`` neither the bundle nor the BERT zip is asked
    for: the facade warns and goes on with zero BERT features."""
    from gsv_tts_tpu_torch import TTS

    monkeypatch.setenv("GSV_OFFLINE", "1")
    t = TTS(models_dir=str(tmp_path / "m"), device="cpu", seed=0, use_bert=True)
    assert server.seen == []
    assert t.tts_config.cnroberta is None and t._bert_loaded
    assert any("GSV_OFFLINE" in r.getMessage() for r in caplog.records)
    assert not (tmp_path / "m" / "g2p").exists()


def test_a_404_leaves_no_zip(online, server, tmp_path):
    """A missing asset raises from ``download_model`` and degrades in
    ``check_pretrained_models`` and ``download_bert``; no zip is left behind."""
    import requests

    pdl, _ = online
    with pytest.raises(requests.HTTPError):
        pdl.download_model("missing.zip", tmp_path, download_url=url(server))
    del server.files["pretrained_models6.zip"]
    assert pdl.check_pretrained_models(tmp_path / "m") is False
    assert pdl.download_bert(tmp_path / "m") is False
    assert ("GET", "/chinese-roberta.zip") in server.seen
    assert not list(tmp_path.rglob("*.zip"))
    assert np.all([not (tmp_path / "m" / n).exists() for n in ("chinese-hubert-base", "sv")])


def test_tts_without_requests_warns_and_opens_no_connection(tmp_path, monkeypatch, caplog):
    """Online, with ``requests`` absent (as on a host that lacks it) and a
    ``models_dir`` without ``g2p`` and ``sv``: the mirror probe cannot import
    it, and ``TTS()`` still constructs, logs the missing assets and opens no
    connection."""
    import socket
    import sys

    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch import download as pdl

    monkeypatch.delenv("GSV_OFFLINE", raising=False)
    monkeypatch.setattr(pdl, "_base_url", None)
    monkeypatch.setitem(sys.modules, "requests", None)
    connects = []

    def refuse(sock, addr):
        connects.append(addr)
        raise OSError("this test opens no connection")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    models = tmp_path / "models"
    (models / "chinese-hubert-base").mkdir(parents=True)
    t = TTS(models_dir=str(models), device="cpu", seed=0)
    assert t.models_dir == models and connects == []
    assert any("Missing pretrained assets" in r.getMessage() and "requests" in r.getMessage()
               for r in caplog.records)
    assert not (models / "g2p").exists() and not (models / "sv").exists()

"""The ctypes side of the port's CUDA libraries against their sources,
without a card or ``nvcc``: every ``extern "C"`` entry of a library's
``.cu`` files is bound (``argtypes`` and ``restype``) by the library's
``load_kernels`` and nothing else is, every ``.cu`` file belongs to one
library, and each argument struct the wrappers fill has the layout of its
C struct (compiled with the host's C++ compiler)."""
import ctypes
import re
import subprocess

import pytest

from gsv_tts_tpu_torch import tools
from gsv_tts_tpu_torch.ops import flash_decode, flash_prefill, fused_layer, fused_step
from gsv_tts_tpu_torch.utils import cuda_build

#: library name -> ((library name, sources) as the module declares it, its loader)
LIBRARIES = {
    "gsv_k1": (fused_step.K1_LIBRARY, fused_step.load_kernels),
    "gsv_k2": (fused_step.K2_LIBRARY, fused_step.load_batched_kernels),
    "gsv_k3": (flash_decode.LIBRARY, flash_decode.load_kernels),
    "gsv_k4": (flash_prefill.LIBRARY, flash_prefill.load_kernels),
    "gsv_k5": (fused_step.K5_LIBRARY, fused_step.load_layers_kernels),
    "gsv_k6": (fused_layer.LIBRARY, fused_layer.load_kernels),
    "gsv_probes": (tools.PROBES_LIBRARY, tools.load_kernels),
}

ENTRY = re.compile(r'extern\s+"C"\s+\w+\s*\**\s*(\w+)\s*\(')


class _Entry:
    """A stand-in for a ctypes function: remembers what the loader sets."""

    def __init__(self):
        self.set = set()

    def __setattr__(self, name, value):
        if name in ("argtypes", "restype"):
            self.set.add(name)
        object.__setattr__(self, name, value)


class _Library:
    """A stand-in for the loaded CDLL: hands out one :class:`_Entry` a name."""

    def __init__(self):
        object.__setattr__(self, "entries", {})

    def __getattr__(self, name):
        return self.entries.setdefault(name, _Entry())


def source_entries(sources):
    return {m for s in sources for m in ENTRY.findall((cuda_build.CSRC_DIR / s).read_text())}


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_load_kernels_binds_exactly_the_extern_c_entries(name, monkeypatch):
    """The entries the library's sources export are the names its loader
    gives both ``argtypes`` and ``restype``, and it touches no other name:
    a kernel entry that no wrapper binds, or a binding whose entry is gone,
    fails here rather than on the card."""
    (lib_name, sources), load = LIBRARIES[name]
    assert lib_name == name
    built = []

    def load_library(n, srcs):
        built.append((n, list(srcs)))
        return _Library()

    monkeypatch.setattr(cuda_build, "load_library", load_library)
    lib = load.__wrapped__()
    assert built == [(name, list(sources))]
    bound = {n for n, e in lib.entries.items() if e.set == {"argtypes", "restype"}}
    assert set(lib.entries) == bound, "a name was touched without both argtypes and restype"
    entries = source_entries(sources)
    assert entries, f"no extern \"C\" entry in {sources}"
    assert bound == entries


def test_every_cuda_source_belongs_to_one_library():
    """Each ``csrc/*.cu`` is built into exactly one of the libraries, so
    every entry is bound by exactly one loader."""
    listed = [s for (_, sources), _ in LIBRARIES.values() for s in sources]
    assert sorted(listed) == sorted(p.name for p in cuda_build.CSRC_DIR.glob("*.cu"))


#: struct name -> (source that defines it, the ctypes structure the wrappers fill)
STRUCTS = {
    "K1Args": ("k1_decode_step.cu", fused_step._K1Args),
    "K2Args": ("k2_decode_step_batched.cu", fused_step._K2Args),
    "K5Args": ("k5_decode_layers.cu", fused_step._K5Args),
    "K6Args": ("k6_decode_layer.cu", fused_layer._K6Args),
    "K4Shape": ("k4_flash_prefill.cu", flash_prefill.K4Shape),
    "LayerWeights": ("decode_common.cuh", fused_step._LayerWeights),
    "PsQuantScales": ("decode_step_persistent.cuh", fused_step._QuantScales),
}


@pytest.mark.parametrize("name", sorted(STRUCTS))
def test_argument_struct_layout_matches_the_c_struct(name, tmp_path):
    """The C struct, cut from its source and compiled for the host with
    stand-ins for the types it points at, has every field of the ctypes
    structure at the same offset and the same size: a field added, dropped
    or moved on one side only fails here rather than on the card."""
    cxx = cuda_build.find_cxx()
    if cxx is None:
        pytest.skip("no host C++ compiler to read the struct's layout with")
    source, struct = STRUCTS[name]
    text = (cuda_build.CSRC_DIR / source).read_text()
    body = re.search(r"^struct %s \{.*?^\};" % name, text, re.S | re.M).group(0)
    fields = [n for n, _ in struct._fields_]
    prog = "\n".join(
        ["#include <cstddef>", "#include <cstdio>", "typedef unsigned short bf16;",
         "struct LayerWeights; struct PsTagged; struct PsQuantScales;",
         "#define DEC_MAX_SUPPRESSED 8", body, "int main() {"]
        + [f'  std::printf("%zu\\n", offsetof({name}, {f}));' for f in fields]
        + [f'  std::printf("%zu\\n", sizeof({name}));', "  return 0;", "}"])
    (tmp_path / "layout.cpp").write_text(prog)
    subprocess.run([cxx, "-o", str(tmp_path / "layout"), str(tmp_path / "layout.cpp")],
                   check=True, capture_output=True, timeout=120)
    got = subprocess.run([str(tmp_path / "layout")], check=True, capture_output=True,
                         text=True, timeout=60).stdout.split()
    want = [getattr(struct, f).offset for f in fields] + [ctypes.sizeof(struct)]
    assert [int(v) for v in got] == want, dict(zip(fields + ["sizeof"], zip(got, want)))

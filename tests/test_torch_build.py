"""The CUDA sources' shared Hopper layer (``csrc/hopper.cuh``) and the build
that hashes it (``ops/_build.py``), on the CPU.

The header holds the PTX pieces, the mbarrier watchdog and the launch set-up
that every kernel needs; these tests keep the copies from coming back into
the sources and make an edit of the header rebuild every library.
"""

import os
import re
import shutil

import pytest

from deepfly3d_torch.ops import _build

HEADER = "hopper.cuh"


def _read(name: str) -> str:
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        return f.read()


def _includes_header(name: str) -> bool:
    return f'#include "{HEADER}"' in _read(name + ".cu")


# a definition at the start of a line: qualifiers, a return type, the name
# (an explicit specialisation's <...>), its parameter list; a constant; a macro
_FUNCTION = re.compile(r"^(?:template\s*<[^>\n]*>\s*)?(?:(?:__host__|__device__|__forceinline__|"
                       r"inline|constexpr|static)\s+)*(?!return\b|else\b)[A-Za-z_][\w:]*"
                       r"(?:\s+long)?\s+([A-Za-z_]\w*)\s*(?:<[^>\n]*>)?\s*\(", re.M)
_CONSTANT = re.compile(r"^\s*constexpr\s+[\w:]+(?:\s+long)?\s+(k\w+)\s*=", re.M)
_MACRO = re.compile(r"^#define\s+(\w+)", re.M)


def _defined(text: str) -> set:
    return {m for rx in (_FUNCTION, _CONSTANT, _MACRO) for m in rx.findall(text)}


def test_the_header_defines_the_shared_pieces():
    """The pieces the sources share are the header's, under these names."""
    names = _defined(_read(HEADER))
    assert {"saddr", "mbar_init", "mbar_init_fence", "mbar_arrive", "mbar_expect_tx", "mbar_try",
            "mbar_wait", "bulk_load", "prefetch_l2", "consumers_sync", "set_max_regs_dec",
            "set_max_regs_inc", "desc_of", "wg_fence", "wg_commit", "wg_wait", "wgmma", "split4",
            "round_up", "current_device", "allow_smem", "kMaxDevices", "kMaxSmem", "kHiMask",
            "kWatchdogCycles"} <= names


@pytest.mark.parametrize("name", _build.SOURCES)
def test_target_follows_the_header(name, tmp_path, monkeypatch):
    """Every source's library is rebuilt when a header under csrc/ changes
    (the build hashes every header with every source, whether it includes
    it or not), and only then."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = _build._target(name)
    assert _build._target(name) == before
    with open(csrc / HEADER, "a") as f:
        f.write("\n// an edit\n")
    assert _build._target(name) != before


@pytest.mark.parametrize("name", _build.SOURCES)
def test_no_source_redefines_a_header_piece(name):
    """No source defines again a function, constant or macro that the header
    defines: a piece one source needs in another form has a name of its own."""
    again = _defined(_read(HEADER)) & _defined(_read(name + ".cu"))
    assert not again, f"{name}.cu defines {sorted(again)}, which {HEADER} defines"


@pytest.mark.parametrize("name", _build.SOURCES)
def test_sources_that_use_mbarrier_or_wgmma_include_the_header(name):
    """A source that issues mbarrier or wgmma instructions, or calls the
    header's wrappers of them, takes them from the header; the others
    (upsample_add.cu, decode.cu) need none of it."""
    text = _read(name + ".cu")
    uses = re.search(r"mbarrier\.|wgmma\.|\b(?:mbar_\w+|bulk_load|desc_of|wg_\w+|wgmma\w*)\s*[<(]",
                     text)
    assert (uses is not None) == _includes_header(name)
    assert _includes_header(name) == (name not in ("upsample_add", "decode"))

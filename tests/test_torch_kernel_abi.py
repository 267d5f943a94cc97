"""The ctypes signatures of the port's kernel library against its C source.

`wgatools_tpu_torch/kernels/_build.py` declares each C entry point's
argument types by hand (`SIGNATURES`, the stream appended last, and
`HELPERS`); a declaration that drifts from `csrc/*.cu` would only show as
a bad launch on the card.  These tests parse every `extern "C"` function
of `csrc/*.cu` and hold each declaration against it, position by
position, with no compiler.
"""

import ctypes
import glob
import os
import re

import pytest

from wgatools_tpu_torch.kernels import _build

_EXTERN = re.compile(
    r'extern\s+"C"\s+(?P<ret>[\w\s*]+?)\s*\bwga_(?P<name>\w+)\s*'
    r"\((?P<params>[^)]*)\)\s*\{"
)
# the C spelling of each ctypes kind the library uses
_KIND = {
    ctypes.c_void_p: "pointer",
    ctypes.c_char_p: "pointer",
    ctypes.c_int: "int",
    ctypes.c_longlong: "long long",
}


def _kind(c_type):
    """'pointer', 'int' or 'long long' for a C type (without its name)."""
    c_type = " ".join(c_type.replace("*", " * ").split())
    if "*" in c_type:
        return "pointer"
    if c_type in ("int", "long long"):
        return c_type
    raise AssertionError(f"C type {c_type!r} has no ctypes kind here")


def parse_entry_points(text):
    """{name: (result kind, [(parameter kind, parameter name)])} of the
    `extern "C"` functions wga_<name> defined in the C source text."""
    found = {}
    for m in _EXTERN.finditer(text):
        params = []
        for p in m.group("params").split(","):
            p = " ".join(p.split())
            if not p or p == "void":
                continue
            ident = re.search(r"(\w+)$", p)
            params.append((_kind(p[: ident.start()]), ident.group(1)))
        found[m.group("name")] = (_kind(m.group("ret")), params)
    return found


def _source_entry_points():
    found = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))):
        with open(path) as f:
            for name, decl in parse_entry_points(f.read()).items():
                assert name not in found, f"wga_{name} is defined twice"
                found[name] = decl
    return found


ENTRY_POINTS = _source_entry_points()


def test_parser_reads_kinds_and_names():
    src = """
    extern "C" int wga_a(const void* x, void *y, int B, long long  N,
                         void* stream) {
      return 0;
    }
    extern "C" const char* wga_b(int err) { return nullptr; }
    static int wga_c(int x) { return x; }
    """
    assert parse_entry_points(src) == {
        "a": ("int", [("pointer", "x"), ("pointer", "y"), ("int", "B"),
                      ("long long", "N"), ("pointer", "stream")]),
        "b": ("pointer", [("int", "err")]),
    }


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_kernel_signature_matches_source(name):
    assert name in ENTRY_POINTS, f"no extern \"C\" wga_{name} in csrc/*.cu"
    ret, params = ENTRY_POINTS[name]
    assert ret == "int"
    declared = [_KIND[t] for t in _build.SIGNATURES[name]] + ["pointer"]
    source = [kind for kind, _ in params]
    assert len(source) == len(declared), (
        f"wga_{name}: {len(source)} parameters in the source, "
        f"{len(declared)} declared (stream included)"
    )
    for pos, (want, (got, pname)) in enumerate(zip(declared, params)):
        assert got == want, (
            f"wga_{name} parameter {pos} ({pname}): {got} in the source, "
            f"{want} declared"
        )
    assert params[-1][1] == "stream"


@pytest.mark.parametrize("name", sorted(_build.HELPERS))
def test_helper_signature_matches_source(name):
    assert name in ENTRY_POINTS, f"no extern \"C\" wga_{name} in csrc/*.cu"
    ret, params = ENTRY_POINTS[name]
    argtypes, restype = _build.HELPERS[name]
    assert ret == _KIND[restype]
    assert [kind for kind, _ in params] == [_KIND[t] for t in argtypes]


def test_every_entry_point_is_declared():
    declared = set(_build.SIGNATURES) | set(_build.HELPERS)
    assert set(ENTRY_POINTS) == declared
    assert set(_build.LAUNCHES) == set(_build.SIGNATURES)

"""Every public name and argument of the JAX package has its counterpart in
the port, except the names left out on purpose (``LEFT_OUT``).

Both packages are parsed with ``ast``, not imported, so the test takes
milliseconds.  For each module of ``gr_lora_tpu`` (none whose path has a
part that starts with an underscore) the port's module of the same path
must define, at module level:

- every public function, with every argument name of the JAX function;
- every public class, with every public method (and ``__init__``), each
  with every argument name of the JAX method;
- every public module-level assignment and, in an ``__init__``, every
  public name it imports; ``__version__``, ``__all__`` and the lazy
  attributes of a ``_LAZY`` tuple.

A port function that takes ``**kwargs`` does not stand in for named
arguments: the names must be spelt out.
"""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: What the port leaves out on purpose, by JAX module and name (a whole
#: module is listed by its name alone).  ROADMAP.md item 14 names the
#: same list with the same reasons.
LEFT_OUT = {
    # The Pallas kernels are ported as the port's own modules and classes:
    # pallas_direct -> ops/direct (DirectSpectra, DirectPeaks),
    # pallas_frontend -> ops/chunk_spectra (ChunkSpectra), pallas_overlap
    # -> ops/overlap_spectra (OverlapSpectra), pallas_peaks ->
    # ops/overlap_peaks (OverlapPeaks), pallas_rdft -> ops/rdft_spectra /
    # ops/rdft_peaks (RdftSpectra, RdftPeaks).
    "ops.pallas_direct": None,
    "ops.pallas_frontend": None,
    "ops.pallas_overlap": None,
    "ops.pallas_peaks": None,
    "ops.pallas_rdft": None,
    # XLA's precision tiers: the port pins full f32 with
    # ops/cplx.f32_precision and takes compute_dtype instead.
    "ops.cplx": {"cmatmul.precision", "cmatmul_packed.precision"},
    # XLA's zoom-DFT plan objects: the port's one plan is ops/dft.ZoomDft,
    # which ops/__init__ exports in their place; overlap_plan is the
    # OverlapPlan class there.
    "ops.dft": {"BandSpec", "ZoomDftPlan"},
    "ops.__init__": {"BandSpec", "ZoomDftPlan"},
    "ops.overlap_dft": {"overlap_plan"},
    # jax.distributed's platform choice: torch.distributed takes a backend.
    "dist.multihost": {"initialize.platform"},
    # A jax.sharding placement: the port's ring takes mesh= (a ShardGrid).
    "pipeline.device_ring": {"DeviceRing.__init__.sharding"},
}


def _args(fn: ast.FunctionDef) -> list:
    """The argument names a caller can pass (``**kwargs`` names none)."""
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    return names


def _public(path: Path) -> dict:
    """{name: ("def", args) | ("class", {method: args}) | ("name",)}."""
    tree = ast.parse(path.read_text())
    init = path.name == "__init__.py"
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            if not node.name.startswith("_"):
                out[node.name] = ("def", _args(node))
        elif isinstance(node, ast.ClassDef):
            if not node.name.startswith("_"):
                out[node.name] = ("class", {
                    b.name: _args(b) for b in node.body
                    if isinstance(b, ast.FunctionDef)
                    and (not b.name.startswith("_") or b.name == "__init__")})
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if not t.id.startswith("_") or t.id in ("__version__",
                                                         "__all__"):
                    out[t.id] = ("name",)
                if t.id == "_LAZY":
                    for e in node.value.elts:
                        out[e.value] = ("name",)
        elif init and isinstance(node, ast.ImportFrom):
            for al in node.names:
                name = al.asname or al.name
                if not name.startswith("_"):
                    out[name] = ("name",)
    return out


def _modules(pkg: str) -> dict:
    root = ROOT / pkg
    out = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).with_suffix("")
        if any(p.startswith("_") and p != "__init__" for p in rel.parts):
            continue
        out[".".join(rel.parts)] = path
    return out


def gaps(jax_side: dict, port_side: dict) -> list:
    """What ``jax_side`` has and ``port_side`` lacks, outside LEFT_OUT;
    each maps a module name to its :func:`_public` entries."""
    out = []
    for mod, public in jax_side.items():
        skip = LEFT_OUT.get(mod, set())
        if mod in LEFT_OUT and skip is None:
            continue
        if mod not in port_side:
            out.append(f"module {mod}")
            continue
        ours = port_side[mod]
        for name, entry in public.items():
            if name in skip:
                continue
            if name not in ours:
                out.append(f"{mod}.{name}")
                continue
            if entry[0] == "def" and ours[name][0] == "def":
                out += [f"{mod}.{name}({a})" for a in entry[1]
                        if a not in ours[name][1]
                        and f"{name}.{a}" not in skip]
            elif entry[0] == "class" and ours[name][0] == "class":
                for meth, args in entry[1].items():
                    if meth not in ours[name][1]:
                        out.append(f"{mod}.{name}.{meth}")
                        continue
                    out += [f"{mod}.{name}.{meth}({a})" for a in args
                            if a not in ours[name][1][meth]
                            and f"{name}.{meth}.{a}" not in skip]
    return out


def _parsed(pkg: str) -> dict:
    return {mod: _public(path) for mod, path in _modules(pkg).items()}


def test_port_has_every_public_name_and_argument():
    assert gaps(_parsed("gr_lora_tpu"), _parsed("gr_lora_tpu_torch")) == []


def test_left_out_names_exist_in_the_jax_package():
    """Each allow-list entry names something the JAX package has, so the
    list cannot outlive what it excuses."""
    jax_mods = _modules("gr_lora_tpu")
    for mod, names in LEFT_OUT.items():
        assert mod in jax_mods, mod
        if names is None:
            continue
        public = _public(jax_mods[mod])
        for entry in names:
            head, *rest = entry.split(".")
            assert head in public, entry
            if rest and public[head][0] == "def":
                assert rest[0] in public[head][1], entry
            elif rest:
                assert rest[1] in public[head][1][rest[0]], entry


def test_guard_sees_a_gap():
    """The comparison itself: a missing module, function, argument,
    method, method argument and name are each reported, and an argument
    hidden behind ``**kwargs`` counts as missing; LEFT_OUT excuses only
    what it names."""
    jax_side = {"m": _public_from(
        "def f(a, b): pass\n"
        "def g(a, b=1): pass\n"
        "class C:\n    def __init__(self, x): pass\n"
        "    def m(self, y): pass\n"
        "V = 1\n"), "other": {}, "ops.cplx": _public_from(
            "def cmatmul(x, w_re, w_im, precision=None): pass\n"
            "def cmul(a, b, precision=None): pass\n")}
    port_side = {"m": _public_from(
        "def f(a): pass\n"
        "def g(a, **kw): pass\n"
        "class C:\n    def __init__(self): pass\n"), "ops.cplx": _public_from(
            "def cmatmul(x, w_re, w_im): pass\n"
            "def cmul(a, b): pass\n")}
    assert sorted(gaps(jax_side, port_side)) == sorted([
        "m.f(b)", "m.g(b)", "m.C.__init__(x)", "m.C.m", "m.V",
        "module other", "ops.cplx.cmul(precision)"])


def _public_from(src: str) -> dict:
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        p = Path(tmp) / "m.py"
        p.write_text(src)
        return _public(p)

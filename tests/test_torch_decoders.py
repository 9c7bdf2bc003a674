"""The port's decoders and registry against the JAX package's.

Every decoder module of ``rtl_433_tpu_torch/decoders/`` is the JAX
package's module with only its imports pointing at the port's own
``bits``, ``output`` and ``decoders/base.py``: an AST comparison that
ignores imports and docstrings holds each module to its twin. The registry
matches slot for slot (symbol, name, modulation, timings, fields, whether
a decode function exists), and ``register_all`` activates the same
defaults.

The fast dispatch is held to its twin the same way: the modules of the
slicer binding, the gates, the declarative bank and its specs (declared
differences: how the slicer library is built, the decode bank's torch
backend, and ``DeclRunner.decode_many``'s ``device`` where JAX has
``xp``, the rest of that method held to its twin), the Registry
members it runs (``_run``, ``_get_device_bank`` and ``prewarm_trains``
aside), and
``csrc/slicers.cpp``, byte for byte
with ``native/slicers.cpp``. The flex decoder (``decoders/flex.py``) and
the conf parser (``confparse.py``) are their twins. The decode pool,
``decoders/pool.py``, is its twin with two declared differences (no
JAX_PLATFORMS in the worker, whose flex loop calls ``flex_create_device``
where the JAX worker imports a ``flex_device`` that JAX's flex module does
not define).
"""

import ast
import os

import pytest

import rtl_433_tpu.decoders as jdec
import rtl_433_tpu.decoders.base as jbase
import rtl_433_tpu_torch.decoders as tdec
import rtl_433_tpu_torch.decoders.base as tbase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JDIR = os.path.join(REPO, "rtl_433_tpu", "decoders")
TDIR = os.path.join(REPO, "rtl_433_tpu_torch", "decoders")


def _decoder_modules():
    """The modules decoders/__init__.py imports after base, in order."""
    with open(os.path.join(JDIR, "__init__.py")) as f:
        tree = ast.parse(f.read())
    return [a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module is None
            for a in node.names]


MODULES = _decoder_modules()

# deliberate differences between a ported module and its JAX twin, beyond
# imports and docstrings: none
DIFFERENCES = {}


def _strip(tree):
    """Drop imports and docstrings from a module's AST."""
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        body[:] = [n for n in body
                   if not isinstance(n, (ast.Import, ast.ImportFrom))]
        if (isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                              ast.AsyncFunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            del body[0]
    return ast.dump(tree, include_attributes=False)


def test_module_list():
    assert len(MODULES) == 53 and MODULES[0] == "protocols"
    with open(os.path.join(TDIR, "__init__.py")) as f:
        port = ast.parse(f.read())
    assert [a.name for node in port.body
            if isinstance(node, ast.ImportFrom) and node.module is None
            for a in node.names] == MODULES


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax_twin(name):
    trees = []
    for d in (JDIR, TDIR):
        with open(os.path.join(d, name + ".py")) as f:
            trees.append(_strip(ast.parse(f.read())))
    assert name not in DIFFERENCES
    assert trees[0] == trees[1], f"{name}.py differs from its JAX twin"


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_stay_inside_the_port(name):
    """Relative imports only, of the modules the JAX twin imports."""
    with open(os.path.join(TDIR, name + ".py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module in ("__future__", "dataclasses"), node.module
        elif isinstance(node, ast.Import):
            for a in node.names:
                assert a.name in ("math", "time", "datetime", "numpy",
                                  "struct", "re"), a.name


# the modules of the fast dispatch, by path under each package
DISPATCH_MODULES = ["pulse/native_slicers.py", "decoders/gates.py",
                    "decoders/mic_gates.py", "ops/decode_bank.py",
                    "decoders/declarative.py", "decoders/decl_specs.py"]

# deliberate differences, as names left out of the comparison (top-level,
# or ``Class.method``): the port builds its slicer library from its own
# csrc/slicers.cpp (ops/_native.py) and raises when that fails, where the
# JAX package runs make in native/ and reports a failure as "unavailable";
# the decode bank's torch backend (``run_torch``: the CUDA kernel with its
# sparse entry tables, its plain version and the plain emulation of its
# sparse evaluation, the JAX ``xp=jnp`` path, tests/test_torch_decode_bank.py)
# is the port's own, and ``DeclRunner.decode_many`` selects it with
# ``device=`` where JAX takes ``xp=`` (test_decode_many_differs_only_in_
# its_backend holds the rest of the method to its twin)
DISPATCH_DIFFERENCES = {
    "pulse/native_slicers.py": {"_load", "_NATIVE_DIR", "_ASAN", "_SO_NAME",
                                "_SO"},
    "ops/decode_bank.py": {
        *(f"SP_{k}" for k in ("MIN", "MAX", "EL", "LA_LEN", "LA_OFF", "PLEN",
                              "PRE_START", "ALIGN", "NEED", "TF", "MC_MIN",
                              "NRAW", "CHECKS")),
        "CK_FIELDS", "_TABLES", "_i32", "_u32", "spec_rows", "bank_tables",
        "_check", "preamble_plain", "run_torch_plain", "run_torch",
        "run_on", "CHUNK", "CH_GF2", "CH_ADD", "CH_RAW", "sparse_tables",
        "_stages", "_mic_ok", "_code", "_range_mask", "_compress_odd",
        "frame_words", "run_torch_sparse_plain"},
    "decoders/declarative.py": {"DeclRunner.decode_many"},
}
# imports beyond numpy, ctypes and threading: the torch backend's
DISPATCH_IMPORTS = {"ops/decode_bank.py": {"torch", "weakref"}}

# Registry members copied from the JAX package as they are (the host path
# and its decoder debug dumps among them); ``_run`` (no
# ``except RuntimeError`` that would turn a failed build into the host
# path), ``_get_device_bank`` (the bank runs on ``slice_device``) and
# ``prewarm_trains`` (the decode-cache keys are read after the drain-wide
# record freeze; tests/test_torch_device_dispatch.py holds its memo and
# decode cache to JAX's) are the deliberate differences
REGISTRY_COPIED = ["_verbose_decoding", "_use_native", "_get_bank",
                   "_bank_meta", "_build_train_memo", "_memo_plans",
                   "_run_fast", "run_ook_demods", "run_fsk_demods",
                   "_run_host", "maybe_log_bitbuffer", "_log_bitbuffer"]


def _drop_names(tree, names):
    def named(node, names):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            return node.name in names
        if isinstance(node, ast.Assign):
            return all(isinstance(t, (ast.Name, ast.Tuple)) and all(
                isinstance(e, ast.Name) and e.id in names
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]))
                for t in node.targets)
        return False
    tree.body = [n for n in tree.body if not named(n, names)]
    for cls in tree.body:
        if isinstance(cls, ast.ClassDef):
            members = {k.split(".", 1)[1] for k in names
                       if k.startswith(cls.name + ".")}
            cls.body = [n for n in cls.body if not named(n, members)]
    return tree


@pytest.mark.parametrize("rel", DISPATCH_MODULES)
def test_dispatch_module_matches_jax_twin(rel):
    drop = DISPATCH_DIFFERENCES.get(rel, set())
    trees = []
    for pkg in ("rtl_433_tpu", "rtl_433_tpu_torch"):
        with open(os.path.join(REPO, pkg, rel)) as f:
            trees.append(_strip(_drop_names(ast.parse(f.read()), drop)))
    assert trees[0] == trees[1], f"{rel} differs from its JAX twin"


@pytest.mark.parametrize("rel", DISPATCH_MODULES)
def test_dispatch_module_imports_stay_inside_the_port(rel):
    with open(os.path.join(REPO, "rtl_433_tpu_torch", rel)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module in ("__future__", "dataclasses", "typing"), \
                node.module
        elif isinstance(node, ast.Import):
            for a in node.names:
                assert a.name in ("numpy", "ctypes", "threading",
                                  *DISPATCH_IMPORTS.get(rel, ())), a.name


def _decode_many(pkg):
    with open(os.path.join(REPO, pkg, "decoders", "declarative.py")) as f:
        tree = ast.parse(f.read())
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "DeclRunner")
    return next(n for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "decode_many")


def test_decode_many_differs_only_in_its_backend():
    """``DeclRunner.decode_many`` is its JAX twin but for the backend: the
    parameter ``device`` (JAX: ``xp``) and the bank call, where JAX calls
    ``dbk.run(..., xp=xp)`` and the port ``dbk.run_on(device, ...)``."""
    def bank_call(node):
        calls = [n for n in ast.walk(node) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)
                 and isinstance(n.func.value, ast.Name)
                 and n.func.value.id == "dbk"]
        return bool(calls)

    dumps = []
    for pkg in ("rtl_433_tpu", "rtl_433_tpu_torch"):
        fn = _decode_many(pkg)
        assert [a.arg for a in fn.args.args][:2] == ["self", "items"]
        fn.args.args = fn.args.args[:2]
        fn.args.defaults = []
        fn.body = [n for n in fn.body if not bank_call(n)]
        dumps.append(_strip(ast.Module(body=[fn], type_ignores=[])))
    assert [a.arg for a in _decode_many("rtl_433_tpu_torch").args.args] \
        == ["self", "items", "device"]
    assert dumps[0] == dumps[1]


def test_slicer_source_is_a_byte_copy():
    with open(os.path.join(REPO, "native", "slicers.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "rtl_433_tpu_torch", "csrc",
                           "slicers.cpp"), "rb") as f:
        assert f.read() == want


def _registry_members(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    top = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "Registry")
    members = {n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)}
    return top, members


@pytest.mark.parametrize("name", ["_decl_symbols"] + REGISTRY_COPIED)
def test_registry_dispatch_matches_jax_twin(name):
    dumps = []
    for d in (JDIR, TDIR):
        top, members = _registry_members(os.path.join(d, "base.py"))
        node = top.get(name) or members[name]
        dumps.append(_strip(ast.Module(body=[node], type_ignores=[])))
    assert dumps[0] == dumps[1], f"Registry.{name} differs from its twin"


def test_registry_dispatch_state():
    """The caches and switches of the default dispatch start as in JAX."""
    j, t = jdec.Registry(), tdec.Registry()
    for k in ("_banks", "_dec_cache", "_dec_cache_version", "dec_cache_max",
              "_train_cache", "train_cache_max", "decoder_verbose",
              "decl_decode", "device_slice", "_device_banks"):
        assert getattr(t, k) == getattr(j, k), k
    assert tbase._MISS is not None and tbase._MISS is not jbase._MISS
    assert tbase._decl_symbols() == jbase._decl_symbols()


def test_registration_order():
    """The decorators ran in the same order: the same symbols map to the
    twin functions, in the same insertion order."""
    assert list(tbase._DECODERS) == list(jbase._DECODERS)
    for sym, fn in tbase._DECODERS.items():
        jfn = jbase._DECODERS[sym]
        assert fn.__name__ == jfn.__name__, sym
        assert fn.__module__.split(".")[-1] == jfn.__module__.split(".")[-1]


_JREG = jdec.Registry()
_TREG = tdec.Registry()
_FIELDS = ("num", "symbol", "name", "modulation", "short_width",
           "long_width", "sync_width", "gap_limit", "reset_limit",
           "tolerance", "priority", "disabled", "fields", "ref_file")


@pytest.mark.parametrize("num", range(1, len(_JREG.slots)))
def test_registry_slot(num):
    j, t = _JREG.get(num), _TREG.get(num)
    assert (j is None) == (t is None)
    if j is None:
        return
    for k in _FIELDS:
        assert getattr(t, k) == getattr(j, k), k
    assert t.decode_fn is not None and j.decode_fn is not None
    assert t.decode_fn.__name__ == j.decode_fn.__name__
    assert t.is_fsk == j.is_fsk


def test_registry_sizes_and_defaults():
    assert len(_TREG.slots) == len(_JREG.slots)
    assert len(_TREG) == len(_JREG) == 378
    assert len(_TREG.implemented()) == len(_JREG.implemented()) == 378
    j, t = jdec.Registry(), tdec.Registry()
    j.register_all()
    t.register_all()
    assert [d.num for d in t.active] == [d.num for d in j.active]
    assert len(t.active) == 335
    j2, t2 = jdec.Registry(), tdec.Registry()
    j2.register_all(1)
    t2.register_all(1)
    assert [d.num for d in t2.active] == [d.num for d in j2.active]


def test_stateful_sets():
    assert tbase.STATEFUL_DECODERS == jbase.STATEFUL_DECODERS
    assert tbase.ARG_STATEFUL_DECODERS == jbase.ARG_STATEFUL_DECODERS
    syms = {d.symbol for d in _TREG.slots if d is not None}
    assert tbase.STATEFUL_DECODERS | tbase.ARG_STATEFUL_DECODERS <= syms


def test_register_unregister_add_device_version():
    """register/unregister/add_device move the active list and _version as
    in the JAX registry."""
    regs = (jdec.Registry(), tdec.Registry())
    for r in regs:
        assert r._version == 0
        r.register(176, "13124")
        r.register(19)
        r.unregister(19)
        r.register_all()
        dev = type(r.get(1))(num=0, symbol="flex", name="x",
                             modulation="OOK_PULSE_PWM")
        r.add_device(dev)
    j, t = regs
    assert t._version == j._version == 5
    assert [d.num for d in t.active] == [d.num for d in j.active]
    assert t.get(176).arg == j.get(176).arg == "13124"
    assert t.active[-1].symbol == "flex"
    with pytest.raises(ValueError):
        t.register(0)


def _pool_tree(pkg):
    with open(os.path.join(REPO, pkg, "decoders", "pool.py")) as f:
        return ast.parse(f.read())


def _body_of(tree, name):
    """The body list of top-level function ``name``, or of method
    ``Class.name``."""
    cls, _, fn = name.rpartition(".")
    scope = tree.body
    if cls:
        scope = next(n for n in scope
                     if isinstance(n, ast.ClassDef) and n.name == cls).body
    return next(n for n in scope
                if isinstance(n, ast.FunctionDef) and n.name == fn).body


def test_pool_matches_jax_twin():
    """decoders/pool.py is its JAX twin but for two declared differences:
    the worker does not set JAX_PLATFORMS (nothing of JAX runs in it), and
    its flex loop imports and calls ``flex_create_device`` where the JAX
    worker names ``flex_device``, which JAX's decoders/flex.py does not
    define (so a JAX pool with a flex spec dies in its worker)."""
    jax_tree, port_tree = _pool_tree("rtl_433_tpu"), _pool_tree(
        "rtl_433_tpu_torch")
    worker = _body_of(jax_tree, "_worker_main")
    dropped = [n for n in worker if "JAX_PLATFORMS" in ast.dump(n)]
    assert len(dropped) == 1
    worker[:] = [n for n in worker if n not in dropped]
    flex_loop = next(n for n in worker if isinstance(n, ast.For)
                     and "flex_specs" in ast.dump(n.iter))
    renamed = 0
    for node in ast.walk(flex_loop):
        if isinstance(node, ast.alias) and node.name == "flex_device":
            node.name, renamed = "flex_create_device", renamed + 1
        elif isinstance(node, ast.Name) and node.id == "flex_device":
            node.id, renamed = "flex_create_device", renamed + 1
    assert renamed == 2
    assert _strip(jax_tree) == _strip(port_tree)


# host modules copied from the JAX package as they are, by path under each
# package, with the standard-library modules each imports
COPIED_MODULES = {"decoders/flex.py": {"re", "typing"},
                  "confparse.py": {"os", "typing"}}


@pytest.mark.parametrize("rel", list(COPIED_MODULES))
def test_copied_module_matches_jax_twin(rel):
    trees = []
    for pkg in ("rtl_433_tpu", "rtl_433_tpu_torch"):
        with open(os.path.join(REPO, pkg, rel)) as f:
            trees.append(_strip(ast.parse(f.read())))
    assert trees[0] == trees[1], f"{rel} differs from its JAX twin"


@pytest.mark.parametrize("rel", list(COPIED_MODULES))
def test_copied_module_imports_stay_inside_the_port(rel):
    with open(os.path.join(REPO, "rtl_433_tpu_torch", rel)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module in ("__future__", *COPIED_MODULES[rel]), \
                node.module
        elif isinstance(node, ast.Import):
            for a in node.names:
                assert a.name in COPIED_MODULES[rel], a.name

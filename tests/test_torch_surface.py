"""The reference's public surface, held against the port's module by
module, from the source alone.

Each module ``src/repro/<path>.py`` is parsed with ``ast`` beside
``src/repro_torch/<path>.py`` (nothing is imported: importing some
reference modules sets process-wide XLA flags).  A call written for the
reference must bind the same in the port, so each case checks that

* the port has the module, at the same path;
* every public top-level name of the reference module is bound in the
  port's, by a definition or a ``from ... import`` (``_`` names, plain
  ``import x`` module bindings and names imported from outside the
  package, stdlib or third-party, are not public surface);
* every public method of a public class is in the port's class;
* every public function or method the two share takes the reference's
  parameters: each of them (``*args`` / ``**kwargs`` by kind), each
  positional one at the reference's position, each optional one
  optional, and no required parameter the reference lacks.  A name
  imported from elsewhere in the package is compared at its definition,
  and a class's constructor is its ``__init__`` or, for a dataclass, its
  fields in order (``Class.__init__.field``);
* every ``--flag`` the reference module's argparse defines.

A difference is reported as ``name``, ``Class.method``, ``func.param``
(``func.*`` / ``func.**`` for the variadic ones) or ``--flag``.  The
deliberate ones are in ``BY_DESIGN`` with their reason; an entry that
no longer matches a difference fails its module's case too."""

import ast
import functools
from pathlib import Path
from typing import NamedTuple

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"
MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))

_PALLAS = ("Pallas's entry point: the port's kernel is a hand-written CUDA "
           "kernel behind ops.py's backend knob")
_SWITCH = ("a process-wide backend switch: the port takes a per-call "
           "`backend` argument, checked against _device.BACKENDS")
_DTYPE = "a jnp dtype alias; the port names torch dtypes where it uses them"
_SHARD = ("a mesh sharding annotation: one card holds the whole model, and "
          "the port's multi-card layouts are leading tensor dimensions")
_MESH = ("a TPU mesh helper: the port has no device mesh (launch/mesh.py "
         "raises and names the TPU meshes)")
_HLO = "reads XLA's HLO text, which a trace of torch ops does not produce"

_DEPRECATED = ("a deprecated keyword of the reference's shim, taken through "
               "run_trace's **legacy (tools/check_deprecated.py forbids "
               "spelling it in a signature); tests/test_torch_api_surface.py "
               "holds its meaning")

BY_DESIGN = {
    # Pallas's entry points and the process-wide backend switches
    ("kernels/decode_attention/kernel.py", "decode_attention_pallas"):
        _PALLAS,
    ("kernels/decode_attention/ops.py", "decode_attention_pallas"): _PALLAS,
    ("kernels/int8_matmul/kernel.py", "int8_matmul_pallas"): _PALLAS,
    ("kernels/int8_matmul/ops.py", "int8_matmul_pallas"): _PALLAS,
    ("kernels/rate_gate/kernel.py", "rate_gate_pallas"): _PALLAS,
    ("kernels/rate_gate/kernel.py", "fused_gate_pallas"): _PALLAS,
    ("kernels/rate_gate/ops.py", "rate_gate_pallas"): _PALLAS,
    ("kernels/rate_gate/ops.py", "fused_gate_pallas"): _PALLAS,
    ("kernels/decode_attention/ops.py", "set_backend"): _SWITCH,
    ("kernels/int8_matmul/ops.py", "set_backend"): _SWITCH,
    ("kernels/int8_matmul/ops.py", "validate_backend"): _SWITCH,
    ("kernels/int8_matmul/ops.py", "MATMUL_BACKENDS"): _SWITCH,
    ("kernels/rate_gate/ops.py", "set_backend"): _SWITCH,
    ("kernels/rate_gate/ops.py", "gate_lowering_supported"):
        "probes Pallas's compiled TPU lowering; the card's kernel is built "
        "by nvcc at first use and raises there if it cannot be",
    ("kernels/rate_gate/ops.py", "fused_admission.seed"):
        "the TPU's hardware PRNG seed has no counterpart on the card: the "
        "port's drawing gate takes a threefry `key`",
    ("kernels/rate_gate/ops.py", "fused_admission.interpret"):
        "Pallas's interpret mode; the port's CPU path is the plain version",
    ("kernels/decode_attention/kernel.py", "F32"): _DTYPE,
    ("kernels/int8_matmul/kernel.py", "I32"): _DTYPE,
    ("kernels/rate_gate/kernel.py", "I32"): _DTYPE,
    ("quant/quantize.py", "I8"): _DTYPE,
    # ported under the torch names
    ("core/probability.py", "build_lut_jnp"):
        "ported as build_lut_torch (the same float32 ops on tensors)",
    ("core/probability.py", "probability_jnp"):
        "ported as probability_torch",
    ("core/model_engine/inference.py", "tpu_latency_us"):
        "ported as card_latency_us: the same roofline at the card's rates",
    # mesh and sharding helpers
    ("models/encdec.py", "shard"): _SHARD,
    ("models/mamba2.py", "shard"): _SHARD,
    ("models/recurrentgemma.py", "shard"): _SHARD,
    ("models/transformer.py", "shard"): _SHARD,
    ("models/vlm.py", "shard"): _SHARD,
    ("models/param.py", "DEFAULT_RULES"): _MESH,
    ("models/param.py", "MeshAxes"): _MESH,
    ("models/param.py", "current_mesh"): _MESH,
    ("models/param.py", "sharding_ctx"): _MESH,
    ("models/param.py", "sharding_fallbacks"): _MESH,
    ("models/param.py", "spec_for"): _MESH,
    ("models/param.py", "tree_pspecs"): _MESH,
    ("models/param.py", "Registrar.pspecs"): _MESH,
    ("core/fenix.py", "pipe_mesh"): _MESH,
    ("core/model_engine/engine_farm.py", "farm_mesh"): _MESH,
    ("launch/roofline.py", "ICI_BW"):
        "the TPU interconnect's link rate; the card's dry run moves no "
        "collective bytes",
    ("launch/dryrun.py", "make_production_mesh"): _MESH,
    ("launch/dryrun.py", "data_axes"): _MESH,
    ("launch/dryrun.py", "sharding_ctx"): _MESH,
    ("launch/dryrun.py", "sharding_fallbacks"): _MESH,
    ("launch/dryrun.py", "spec_for"): _MESH,
    ("launch/dryrun.py", "tree_pspecs"): _MESH,
    ("distributed/elastic.py", "sharding_ctx"): _MESH,
    ("distributed/elastic.py", "tree_pspecs"): _MESH,
    ("launch/train.py", "sharding_ctx"): _MESH,
    ("launch/train.py", "smoke_mesh"): _MESH,
    # the HLO-text helpers of the dry run
    ("launch/dryrun.py", "build_lowered"): _HLO,
    ("launch/dryrun.py", "collective_stats"): _HLO,
    ("launch/dryrun.py", "op_byte_histogram"): _HLO,
    ("launch/dryrun.py", "run_cell.save_hlo"): _HLO,
    # mesh-shaped signatures
    ("distributed/elastic.py", "plan_remesh.mesh"):
        "a jax Mesh; the port's plan takes the card's mesh_shape",
    ("distributed/elastic.py", "plan_remesh.rules"): _MESH,
    ("distributed/elastic.py", "reshard_state.mesh"):
        "a jax Mesh; the port places the state on a `device`",
    ("core/model_engine/engine_farm.py", "make_farm_step.mesh"):
        "a jax Mesh: the port's farm is leading tensor dimensions",
    ("core/model_engine/engine_farm.py", "make_farm_step.masked"):
        "the port's step takes the pipes' `active` mask per call, so one "
        "step serves both of the reference's compiled variants",
    ("core/model_engine/engine_farm.py", "make_farm_step.local_cfg"):
        "required in the port: the reference's default None fails at its "
        "step's first trace (lax.cond traces control_plane_update with it)",
    # deprecated keywords and module bindings
    ("core/fenix.py", "FenixSystem.run_trace.labels_by_flow"): _DEPRECATED,
    ("core/fenix.py", "FenixSystem.run_trace.trace_labels"): _DEPRECATED,
    ("core/fenix.py", "ft"):
        "a module alias (flow_tracker) of the reference's imports",
}


def _parse(path):
    return ast.parse(path.read_text(), filename=str(path))


def _names(target):
    """The names an assignment target binds (not ``x.a`` or ``x[i]``)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for t in target.elts for n in _names(t)]
    if isinstance(target, ast.Starred):
        return _names(target.value)
    return []


class _From(NamedTuple):
    """A name bound by a ``from ... import`` of the package: the module's
    path below the package root, as parts, and the name imported."""
    parts: tuple
    name: str


def _top_level(tree, package, module):
    """{name: node} of the bindings of ``module`` (a path below the
    package root), into ``if``/``try`` blocks, not into functions or
    classes.  A ``from ... import`` of ``package`` (or a relative one)
    binds a ``_From``; one from elsewhere (a third-party or stdlib name)
    binds ``None``; a plain ``import`` binds nothing."""
    out = {}
    here = Path(module).parent.parts

    def walk(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign,
                                   ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for n in _names(t):
                        out[n] = node
            elif isinstance(node, ast.ImportFrom):
                dotted = (node.module or "").split(".") if node.module \
                    else []
                if node.level:
                    parts = here[:len(here) - node.level + 1] + tuple(dotted)
                elif dotted[0] == package:
                    parts = tuple(dotted[1:])
                else:
                    parts = None
                for a in node.names:
                    out[a.asname or a.name] = (
                        None if parts is None else _From(parts, a.name))
            elif isinstance(node, ast.If):
                walk(node.body)
                walk(node.orelse)
            elif isinstance(node, ast.Try):
                walk(node.body)
                for h in node.handlers:
                    walk(h.body)
                walk(node.orelse)
                walk(node.finalbody)
            elif isinstance(node, ast.With):
                walk(node.body)
    walk(tree.body)
    return out


@functools.lru_cache(maxsize=None)
def _bindings(root, module):
    return _top_level(_parse(root / module), root.name, module)


def _definition(root, node):
    """The ``def`` or ``class`` a binding names, following the package's
    ``from ... import`` chain (None for a module or a value)."""
    for _ in range(8):
        if not isinstance(node, _From):
            return node
        for cand in (Path(*node.parts, "__init__.py"),
                     Path(*node.parts).with_suffix(".py")
                     if node.parts else None):
            if cand is not None and (root / cand).exists():
                node = _bindings(root, cand.as_posix()).get(node.name)
                break
        else:
            return None
    return None


def _public(name):
    return not name.startswith("_")


def _methods(cls):
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _dotted(node):
    """``a.b.c`` of a Name / Attribute chain, else ``""``."""
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    return node.id if isinstance(node, ast.Name) else ""


def _is_dataclass(cls):
    return any(_dotted(d.func if isinstance(d, ast.Call) else d)
               in ("dataclass", "dataclasses.dataclass")
               for d in cls.decorator_list)


def _field_optional(value):
    """Whether a dataclass field's class-level value gives it a default
    (None: ``field(init=False)``, not a constructor parameter)."""
    if value is None:
        return False
    if isinstance(value, ast.Call) and \
            _dotted(value.func) in ("field", "dataclasses.field"):
        kw = {k.arg: k.value for k in value.keywords}
        init = kw.get("init")
        if isinstance(init, ast.Constant) and init.value is False:
            return None
        return "default" in kw or "default_factory" in kw
    return True


def _constructor(cls):
    """The parameters ``cls(...)`` takes, as ``_params`` gives them: its
    own ``__init__``, or a dataclass's annotated fields in order (``self``
    first, so either form compares with the other), or None."""
    if "__init__" in _methods(cls):
        return _params(_methods(cls)["__init__"])
    if not _is_dataclass(cls):
        return None
    pos, opt = ["self"], {"self": False}
    for node in cls.body:
        if not (isinstance(node, ast.AnnAssign)
                and isinstance(node.target, ast.Name)) or \
                "ClassVar" in ast.unparse(node.annotation):
            continue
        optional = _field_optional(node.value)
        if optional is not None:
            pos.append(node.target.id)
            opt[node.target.id] = optional
    return pos, opt, False, False


def _params(fn):
    """(positional names, {name: has a default} of every named
    parameter, *args present, **kwargs present)."""
    if isinstance(fn, tuple):
        return fn
    a = fn.args
    pos = [p.arg for p in a.posonlyargs + a.args]
    n_def = len(a.defaults)
    opt = {p: i >= len(pos) - n_def for i, p in enumerate(pos)}
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        opt[p.arg] = d is not None
    return pos, opt, a.vararg is not None, a.kwarg is not None


def _signature_diff(name, ref_fn, port_fn):
    rpos, ropt, rvar, rkw = _params(ref_fn)
    ppos, popt, pvar, pkw = _params(port_fn)
    out = set()
    shared = [p for p in rpos if p in popt]
    for i, p in enumerate(shared):
        if i >= len(ppos) or ppos[i] != p:
            out.add(f"{name}.{p}")
    for p, optional in ropt.items():
        if p not in popt or (optional and not popt[p]):
            out.add(f"{name}.{p}")
    for p, optional in popt.items():
        if p not in ropt and not optional:
            out.add(f"{name}.{p}")
    if rvar and not pvar:
        out.add(f"{name}.*")
    if rkw and not pkw:
        out.add(f"{name}.**")
    return out


def _flags(tree):
    out = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            for arg in node.args:
                if (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)
                        and arg.value.startswith("--")):
                    out.add(arg.value)
    return out


def surface_diff(module, ref_root=REF, port_root=PORT):
    """The reference's public surface in ``module`` that the port's
    counterpart does not offer, as a set of names (see the docstring).
    Each root is a package directory, named as its package."""
    port_path = port_root / module
    if not port_path.exists():
        return {"<module>"}
    ref_tree, port_tree = _parse(ref_root / module), _parse(port_path)
    ref, port = _bindings(ref_root, module), _bindings(port_root, module)
    out = set()
    for name, node in ref.items():
        if node is None or not _public(name):
            continue
        if name not in port:
            out.add(name)
            continue
        if isinstance(node, _From) and node == port[name]:
            continue  # the defining module's own case compares it
        node = _definition(ref_root, node)
        other = _definition(port_root, port[name])
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                isinstance(other, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out |= _signature_diff(name, node, other)
        elif isinstance(node, ast.ClassDef) and \
                isinstance(other, ast.ClassDef):
            ref_init, port_init = _constructor(node), _constructor(other)
            if port_init is None and not other.bases:
                port_init = (["self"], {"self": False}, False, False)
            if ref_init is not None and port_init is not None:
                out |= _signature_diff(f"{name}.__init__", ref_init,
                                       port_init)
            theirs = _methods(other)
            for meth, fn in _methods(node).items():
                if not _public(meth):
                    continue
                qual = f"{name}.{meth}"
                if meth not in theirs:
                    if _public(meth):
                        out.add(qual)
                    continue
                out |= _signature_diff(qual, fn, theirs[meth])
    out |= _flags(ref_tree) - _flags(port_tree)
    return out


def test_one_case_per_reference_module():
    assert len(MODULES) >= 70
    assert all(k[0] in MODULES for k in BY_DESIGN), \
        sorted({k[0] for k in BY_DESIGN} - set(MODULES))
    assert all(isinstance(v, str) and v.strip() for v in BY_DESIGN.values())


_REF_SRC = """
import dataclasses
from typing import ClassVar

@dataclasses.dataclass(frozen=True)
class Config:
    size: int
    rate: float = 1.0
    tags: tuple = dataclasses.field(default_factory=tuple)
    cache: dict = dataclasses.field(default=None, init=False)
    KIND: ClassVar[str] = "ref"

def step(state, cfg, now=0):
    return state
"""

_HELPER_SRC = """
def step(state, cfg, now=0):
    return state
"""

# A port that offers the reference's surface (``step`` imported from a
# helper module), and one mutation of it for each thing the guard holds
# that is not a plain ``def`` in place.
_PORT_OK = ("from .helpers import step\n"
            + _REF_SRC.replace("def step", "def _unused"))
_STEP_IN_PLACE = _HELPER_SRC + _PORT_OK.replace(
    "from .helpers import step\n", "")


@pytest.mark.parametrize("port_src, helper_src, want", [
    (_PORT_OK, _HELPER_SRC, set()),
    (_STEP_IN_PLACE, "", set()),
    (_PORT_OK.replace("    size: int\n    rate: float = 1.0\n",
                      "    rate: float = 1.0\n    size: int = 0\n"),
     _HELPER_SRC, {"Config.__init__.size", "Config.__init__.rate"}),
    (_PORT_OK.replace("    tags: tuple = dataclasses.field("
                      "default_factory=tuple)\n", ""),
     _HELPER_SRC, {"Config.__init__.tags"}),
    (_PORT_OK.replace("    rate: float = 1.0\n", "    rate: float\n"),
     _HELPER_SRC, {"Config.__init__.rate"}),
    (_PORT_OK, _HELPER_SRC.replace("cfg, now=0", "cfg"), {"step.now"}),
], ids=["equal", "defined_in_place", "fields_reordered", "field_missing",
        "default_dropped", "imported_signature_differs"])
def test_guard_sees_constructors_and_imported_signatures(
        tmp_path, port_src, helper_src, want):
    ref_root, port_root = tmp_path / "repro", tmp_path / "repro_torch"
    for root in (ref_root, port_root):
        root.mkdir()
    (ref_root / "mod.py").write_text(_REF_SRC)
    (port_root / "mod.py").write_text(port_src)
    (port_root / "helpers.py").write_text(helper_src)
    assert surface_diff("mod.py", ref_root, port_root) == want


@pytest.mark.parametrize("module", MODULES)
def test_port_offers_the_reference_surface(module):
    diff = surface_diff(module)
    allowed = {name for (mod, name) in BY_DESIGN if mod == module}
    missing = sorted(diff - allowed)
    stale = sorted(allowed - diff)
    assert not missing, f"{module}: the port lacks {missing}"
    assert not stale, f"{module}: BY_DESIGN entries match nothing: {stale}"

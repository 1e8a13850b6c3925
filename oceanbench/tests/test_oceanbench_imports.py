"""Nothing under oceanbench/ imports JAX or the JAX package, and the reference
imports nothing of the program: every module's imports, by whole top-level
name (the port's name begins with the JAX package's)."""
import ast
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "godotoceanwaves_tpu"}
PROGRAM = "godotoceanwaves_tpu_torch"


def imported(path: pathlib.Path) -> set:
    """Top-level names of every absolute import in the module."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def modules(sub: str = "") -> list:
    found = sorted((BENCH / sub).rglob("*.py"))
    assert found, f"no modules under {BENCH / sub}"
    return found


def test_whole_names_are_compared():
    assert PROGRAM.startswith("godotoceanwaves_tpu")
    assert PROGRAM not in JAX_SIDE


def test_no_module_imports_jax_or_the_jax_package():
    for path in modules():
        bad = imported(path) & JAX_SIDE
        assert not bad, f"{path.relative_to(BENCH)} imports {sorted(bad)}"


def test_the_reference_imports_nothing_of_the_program():
    for path in modules("reference"):
        names = imported(path)
        assert PROGRAM not in names, f"{path.relative_to(BENCH)} imports the program"
        assert "oceanbench" not in names or path.name != "oracle.py"


def test_the_harness_imports_the_program_only_in_its_builder():
    """The tests patch the program to plant faults; the harness builds it in one place."""
    importers = {p.relative_to(BENCH).as_posix() for p in modules()
                 if PROGRAM in imported(p) and p.parent.name != "tests"}
    assert importers == {"core/program.py"}, importers

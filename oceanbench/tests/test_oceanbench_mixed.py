"""The cell of a mixed-size session, `mixed_1024_256_64.sim`, on the CPU at a
tiny size (map sizes 64, 32 and 16 in place of 1024, 256 and 64): it is
found by name and runs `correct`; a group's maps scaled, or a cascade that
starts at its index in its group instead of in the session, makes `correct`
false, as does the control."""
import dataclasses
import json

import pytest

from oceanbench.core import manifest
from oceanbench.reference.mixed import RefMixed, size_groups
from oceanbench.reference.ocean import RefOcean
from oceanbench.tests import tiny

CELL = "mixed_1024_256_64.sim"
SIZES = [64, 32, 16]


@pytest.fixture
def root(tmp_path):
    root = tiny.tiny_copy(tmp_path)
    path = root / "oceanbench" / "configs" / "mixed_1024_256_64.json"
    cfg = json.loads(path.read_text())
    cfg["map_sizes"] = SIZES
    path.write_text(json.dumps(cfg))
    return root


def test_the_cell_is_found_and_runs_correct(root):
    cell = manifest.find_cell(CELL, root=root)
    assert cell.config["map_sizes"] == SIZES and cell.workload["driver"] == "sim_mixed"
    assert {"step_launches.mixed_1024_256_64", "group_issue_host_ms.mixed_1024_256_64",
            "step_roofline_pct.mixed_1024_256_64"} <= set(cell.readers)
    result = tiny.run(root, CELL)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result["checks"]) == list(cell.workload["limits"])


def test_the_stated_config_names_the_stated_sizes():
    cell = manifest.find_cell(CELL)
    assert cell.config["map_sizes"] == [1024, 256, 64]
    assert [n for n, _ in size_groups(cell.config["map_sizes"])] == [1024, 256, 64]
    specs = [dict(c, spectrum_seed=[1, 2]) for c in cell.config["cascades"]]
    ref = RefMixed(dict(cell.config, map_sizes=[16, 8, 16]), specs, 0.02, "cpu")
    assert [(g.n, g.indices) for g in ref.groups] == [(16, (0, 2)), (8, (1,))]
    # the session's clock: cascade i starts at 120 + pi i by its index in the session
    whole = RefOcean(dict(cell.config, map_size=16), specs, 0.02, "cpu").t0
    assert ref.groups[0].t0 == [whole[0], whole[2]] and ref.groups[1].t0 == [whole[1]]


def one_group_scaled(monkeypatch):
    from godotoceanwaves_tpu_torch.models import ocean
    real = ocean.step

    def step(config, state, params, dt):
        new, maps = real(config, state, params, dt)
        if config.map_size != SIZES[1]:
            return new, maps
        return new, dataclasses.replace(maps, displacement=maps.displacement * (1 + 1e-2),
                                        normal=maps.normal * (1 + 1e-2))
    monkeypatch.setattr(ocean, "step", step)


def times_by_index_in_group(monkeypatch):
    from godotoceanwaves_tpu_torch.models import ocean
    real = ocean.init_state
    monkeypatch.setattr(ocean, "init_state",
                        lambda config, params, indices=None: real(config, params))


@pytest.mark.parametrize("fault", [one_group_scaled, times_by_index_in_group],
                         ids=lambda f: f.__name__)
def test_a_broken_session_is_not_correct(fault, root, monkeypatch):
    fault(monkeypatch)
    result = tiny.run(root, CELL)
    assert not result["correct"] and result["failed"] > 0, result["checks"]


def test_the_control_is_not_correct(root):
    result = tiny.run(root, CELL, control=True)
    assert not result["correct"], result["checks"]

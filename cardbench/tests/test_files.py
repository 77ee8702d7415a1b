"""BENCHMARK.json and every configuration, cell, traffic mix and metric
file: they parse, keep to the contract's names and limits, and the
harness finds each by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

from cardbench import run as CR
from cardbench.yardstick import compare

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / 'cardbench'
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['cardbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(BENCH['command']) <= 32
    assert (ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024


def test_names_units_and_text():
    named = (BENCH['configs'] + BENCH['workloads'] + BENCH['end_to_end']
             + BENCH['per_layer'])
    names = [x['name'] for x in named]
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        group_names = [x['name'] for x in BENCH[group]]
        assert len(group_names) == len(set(group_names))
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')
    for x in BENCH['configs'] + BENCH['workloads']:
        assert 1 <= len(x['why']) <= 200 and '\n' not in x['why']
    for c in BENCH['configs']:
        assert 1 <= len(c['source']) <= 200
        for k in c['reduced']:
            assert NAME.match(k)
    for m in BENCH['per_layer']:
        assert 1 <= len(m['layer']) <= 200


def test_bounds():
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25, m
    setup, = [m for m in BENCH['end_to_end'] if m['name'] == 'setup_s']
    assert 'workloads' not in setup


def test_chips():
    fours = [w for w in BENCH['workloads'] if w['chips'] == 4]
    assert all(w['chips'] in (1, 4) for w in BENCH['workloads'])
    assert len(fours) <= max(1, len(BENCH['workloads']) // 4)


def test_pairs_once_and_configs_used():
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}
    files = [c['file'] for c in BENCH['configs']]
    assert len(files) == len(set(files))


@pytest.mark.parametrize('cell', CELLS)
def test_cell_is_found_by_name(cell):
    bench, entry, spec, config, mix = CR.cell_spec(cell)
    assert spec['name'] == cell and spec['why'] == entry['why']
    kind = importlib.import_module(f'cardbench.traffic.{mix["kind"]}')
    e2e, layer = CR.cell_metrics(bench, cell, kind.END_TO_END)
    names = {m['name'] for m in e2e}
    assert 'setup_s' in names and len(names) >= 2
    assert layer
    for m in layer:
        assert (HERE / 'metrics' / f"{m['name']}.py").exists()
        assert callable(CR.load_metric(m['name']).read)
        # every moves target is reported in every cell listed
        assert m['moves'] in names
    for m in e2e:
        if m['name'] != 'setup_s':
            assert m['name'] in kind.END_TO_END
    assert set(spec['limits']) and all(v >= 0 for v in
                                       spec['limits'].values())


@pytest.mark.parametrize('config', [c['name'] for c in BENCH['configs']])
def test_config_applies_to_the_port_and_the_reference(config):
    from hector_torch.config import DEFAULT_CONFIG
    from cardbench.reference.config import DEFAULT_CONFIG as REF
    entry, = [c for c in BENCH['configs'] if c['name'] == config]
    spec = json.loads((ROOT / entry['file']).read_text())
    assert spec['name'] == config and spec['source'] == entry['source']
    assert spec['reduced'] == entry['reduced'] == []
    port, ref = (compare.port_config(base, spec) for base in
                 (DEFAULT_CONFIG, REF))
    for group in ('solver', 'mpc'):
        for key, value in spec[group].items():
            want = tuple(value) if isinstance(value, list) else value
            assert getattr(getattr(port, group), key) == want
            assert getattr(getattr(ref, group), key) == want


def test_unknown_setting_raises():
    from hector_torch.config import DEFAULT_CONFIG
    with pytest.raises(KeyError):
        compare.port_config(DEFAULT_CONFIG, {'mpc': {'horizn': 10}})


def test_every_metric_file_is_listed():
    listed = {m['name'] for m in BENCH['per_layer']}
    files = {p.name[:-3] for p in (HERE / 'metrics').glob('*.py')}
    assert files == listed


def test_check_budget():
    """A full check with 24 cells fits the driver's 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200

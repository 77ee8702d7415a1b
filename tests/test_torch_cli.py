"""The port's command line (``python -m hector_torch``) and viewers
against the JAX package's (``hector/cli.py``, ``hector/io/{live,html_viz,
keyboard,viz}.py``).

``run``, ``batch`` and ``replay`` run in float32 on both sides (both CLIs
build float32 plants), the port on ``--device cpu``; JAX's ``batch`` runs
with 64-bit types off, as in a default process, so that its scenario masks
are drawn in float32 as the port's CLI draws them.  The viewers are held
to JAX's on the same state in float64.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector import cli as JCLI
from hector.config import DEFAULT_CONFIG as JCFG
from hector.io import html_viz as JHTML
from hector.io import keyboard as JKB
from hector.io import live as JLIVE
from hector.io import trajectory as JTRAJ
from hector.plant import srb as JSRB

from hector_torch import cli as TCLI
from hector_torch.config import DEFAULT_CONFIG as TCFG
from hector_torch.io import html_viz as THTML
from hector_torch.io import keyboard as TKB
from hector_torch.io import live as TLIVE
from hector_torch.plant import srb as TSRB

from .test_torch_slice import todict

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 closed loops of the two packages, 10 periods: heights and the
# distance walked within 1e-5 m, the worst complementarity (~1e-6) within
# 1 % and the worst dual residual (~3e-5 N) within 1e-5 N (both set by
# the float32 Mehrotra iterates' last digits), fallen counts equal
M_TOL = 1e-5
MU_RTOL = 1e-2
R_DUAL_TOL = 1e-5


def _cli(main, argv, x64=True):
    buf = io.StringIO()
    with jax.enable_x64(x64), contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue()


def _json_head(text):
    """The JSON object a command printed first."""
    return json.JSONDecoder().raw_decode(text.lstrip())[0]


def test_run_matches_jax():
    argv = ['run', '--vx', '0.4', '--seconds', '0.05']
    _, out_j = _cli(JCLI.main, argv)
    rec, out_t = _cli(TCLI.main, ['--device', 'cpu'] + argv)
    j, t = _json_head(out_j), _json_head(out_t)
    assert rec == t and list(t) == list(j)
    for k in ('mean_height', 'min_height', 'x_traveled'):
        assert abs(t[k] - j[k]) < M_TOL, k
    assert t['fallen_frac'] == j['fallen_frac'] == 0.0
    assert t['qp_mu_max'] == pytest.approx(j['qp_mu_max'], rel=MU_RTOL)
    assert abs(t['qp_r_dual_max'] - j['qp_r_dual_max']) < R_DUAL_TOL


def test_batch_matches_jax(tmp_path):
    argv = ['batch', '--batch', '16', '--seconds', '0.05', '--seed', '3']
    _, out_j = _cli(JCLI.main, argv, x64=False)
    log = str(tmp_path / 'm.jsonl')
    ckpt = str(tmp_path / 'ckpt')
    rec, out_t = _cli(TCLI.main, ['--device', 'cpu'] + argv
                      + ['--log', log, '--checkpoint', ckpt])
    j, t = _json_head(out_j), _json_head(out_t)
    assert list(t) == list(j) and rec == t
    assert json.loads(open(log).read()) == t
    assert t['batch'] == 16.0 and t['devices'] == 1.0 and j['devices'] == 8.0
    assert t['fallen_count'] == j['fallen_count']
    assert abs(t['mean_height'] - j['mean_height']) < M_TOL
    assert t['qp_mu_max'] == pytest.approx(j['qp_mu_max'], rel=MU_RTOL)
    assert f'checkpointed to {ckpt}' in out_t
    assert os.listdir(ckpt) == ['10']


def test_replay_matches_jax(tmp_path):
    n = 40
    t = np.arange(n) * 0.005
    states = np.zeros((n, 12))
    states[:, 3] = 0.3 * t
    states[:, 5] = 0.55
    states[:, 9] = 0.3
    path = str(tmp_path / 'walk.csv')
    JTRAJ.write_csv(path, t, states)
    for extra in ([], ['--closed-loop']):
        _, out_j = _cli(JCLI.main, ['replay', path] + extra)
        rec, out_t = _cli(TCLI.main, ['--device', 'cpu', 'replay', path]
                          + extra)
        j, r = _json_head(out_j), _json_head(out_t)
        assert rec == r and list(r) == list(j)
        if not extra:
            assert r == j
            continue
        for k in ('rows', 'periods', 'seconds', 'fallen'):
            assert r[k] == j[k], k
        for k in ('pos_err_mean', 'pos_err_final', 'pos_err_max',
                  'height_err_mean'):
            assert abs(r[k] - j[k]) <= 1.0001e-4, k   # one rounding unit


def test_no_card_without_device_cpu_fails():
    """No silent CPU run: without a card, every command but a --device
    cpu one exits with an error naming the fix."""
    proc = subprocess.run(
        [sys.executable, '-m', 'hector_torch', 'run', '--seconds', '0.01'],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert 'no CUDA device' in proc.stderr and '--device' in proc.stderr
    assert proc.stdout == ''
    for argv in (['batch', '--batch', '4'], ['bench']):
        with pytest.raises(SystemExit) as exc:
            _cli(TCLI.main, argv)
        assert exc.value.code == 2


def test_run_whole_body_and_plot(tmp_path):
    """The tier-2 plant under the 'kf' estimator runs from the CLI, and
    --plot writes the tracking figure."""
    png = str(tmp_path / 'track.png')
    rec, out = _cli(TCLI.main, ['--device', 'cpu', 'run', '--plant',
                                'whole-body', '--estimator', 'kf',
                                '--seconds', '0.02', '--plot', png])
    assert rec['fallen_frac'] == 0.0 and np.isfinite(rec['mean_height'])
    assert f'wrote {png}' in out and os.path.getsize(png) > 1000


def _plant_pair(seed):
    """One perturbed standing state: JAX's unbatched, the port's 1 lane,
    float64."""
    rng = np.random.default_rng(seed)
    p = JSRB.init_plant_state(JCFG, dtype=jnp.float64)
    quat = np.array([1.0, 0.03, -0.05, 0.2])
    p = p._replace(position=p.position + rng.normal(0, 0.02, 3),
                   quat=jnp.asarray(quat / np.linalg.norm(quat)),
                   q=p.q + rng.normal(0, 0.2, (2, 5)),
                   contact=jnp.asarray([True, False]))
    arrays = {k: np.asarray(v)[None] for k, v in todict(p).items()}
    t = TSRB.PlantState(*[torch.tensor(arrays[k])
                          for k in TSRB.PlantState._fields])
    return p, t


@pytest.mark.parametrize('seed', range(3))
def test_live_frame_matches_jax(seed):
    p_j, p_t = _plant_pair(seed)
    geo_j = JLIVE.frame_geometry(p_j, JCFG)
    geo_t = TLIVE.frame_geometry(p_t, TCFG)
    for a, b in zip(geo_j, geo_t):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-12, rtol=0)
    for sh, sl in ((0.0, 1.0), (0.2, 0.4)):
        args = (np.asarray(p_j.position), np.array([0.01, -0.02, 0.3]))
        rest = (np.array([180.0, 0.0]), 1.25, 'cmd vx=+0.50')
        f_j = JLIVE.render_frame(*args, *geo_j, *rest, step_height=sh,
                                 step_length=sl)
        f_t = TLIVE.render_frame(*args, *geo_t, *rest, step_height=sh,
                                 step_length=sl)
        assert f_t == f_j


def test_skeleton_and_html_match_jax(tmp_path):
    frames_j, frames_t = [], []
    for seed in range(3):
        p_j, p_t = _plant_pair(seed)
        frames_j.append(JHTML.skeleton_points(p_j.position, p_j.quat, p_j.q))
        frames_t.append(THTML.skeleton_points(p_t.position[0], p_t.quat[0],
                                              p_t.q[0]))
        assert frames_t[-1].shape == (26, 3)
        np.testing.assert_allclose(frames_t[-1], frames_j[-1], atol=1e-12,
                                   rtol=0)
    assert THTML.segments() == JHTML.segments()
    contacts = np.array([[1, 0], [0, 1], [1, 1]])
    forces = np.random.default_rng(1).normal(0, 50, (3, 2, 3))
    out_j, out_t = str(tmp_path / 'j.html'), str(tmp_path / 't.html')
    JHTML.export_html(np.stack(frames_j), contacts, out_j, 0.005,
                      terrain=(0.03, 0.5), forces=forces, title='hector <x>')
    THTML.export_html(np.stack(frames_j), contacts, out_t, 0.005,
                      terrain=(0.03, 0.5), forces=forces, title='hector <x>')
    assert open(out_t, 'rb').read() == open(out_j, 'rb').read()


def test_keyboard_matches_jax():
    keys = list('wwwwdjjl  kiissaaaq') + ['w'] * 50
    v_j, v_t = JKB.UserValue(), TKB.UserValue()
    for k in keys:
        v_j, v_t = JKB.update_value(v_j, k), TKB.update_value(v_t, k)
        assert (v_t.lx, v_t.ly, v_t.rx, v_t.ry) == \
            (v_j.lx, v_j.ly, v_j.rx, v_j.ry)
        assert TKB.value_to_command(v_t) == JKB.value_to_command(v_j)
    assert TKB.inv_normalize(0.3, -1.5, 1.5) == JKB.inv_normalize(0.3, -1.5,
                                                                  1.5)


def test_view_and_export_html_commands_run(tmp_path):
    """tests/test_live.py and tests/test_html_viz.py's CLI checks on the
    port: one frame a period to stdout, and a 20-frame HTML export."""
    _, out = _cli(TCLI.main, ['--device', 'cpu', 'view', '--vx', '0.4',
                              '--seconds', '0.05', '--speed', '0'])
    assert out.count(TLIVE.ANSI_HOME) == 10
    assert 'Fz=' in out and 'O' in out
    html = str(tmp_path / 'e2e.html')
    rep, out = _cli(TCLI.main, ['--device', 'cpu', 'export-html', html,
                                '--vx', '0.4', '--seconds', '0.1'])
    assert rep == json.loads(out) and rep['frames'] == 20
    s = open(html).read()
    assert len(s) > 5000 and 'hector srb' in s
    d = json.loads(re.search(r'const D=(\{.*?\});\n', s, re.S).group(1))
    assert len(d['pts']) == 20 and len(d['force']) == 20


def test_teleop_live_headless(monkeypatch):
    """``teleop --live`` through a fake terminal: keys steer, one frame a
    period, q quits (tests/test_live.py:60-85)."""
    class FakeTerm:
        def __init__(self):
            self.keys = ['w', 'w', None, None, 'q']

        def __enter__(self):
            return self

        def __exit__(self, *a):
            pass

        def poll_key(self, timeout=0.0):
            return self.keys.pop(0) if self.keys else 'q'

    monkeypatch.setattr(TKB, 'RawTerminal', lambda: FakeTerm())
    _, out = _cli(TCLI.main, ['--device', 'cpu', 'teleop', '--live'])
    assert out.count(TLIVE.ANSI_HOME) == 4
    assert 'O' in out and 'Fz=' in out

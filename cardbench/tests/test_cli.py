"""The command: without a card, or without the program beside it, it
exits with another code than 0 and prints no result."""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ARGS = ['-m', 'cardbench.run', '--workload', 'plan-fused-32k', '--seed',
        str(2**31 + 3), '--seconds', '1', '--trace', '0']


def test_no_card_no_result():
    out = subprocess.run([sys.executable] + ARGS, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if out.returncode == 0:        # a machine with a card: a whole run
        assert out.stdout.strip().splitlines()[-1].startswith('{')
        return
    assert out.returncode == 2 and out.stdout == ''


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'cardbench', tmp_path / 'cardbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run([sys.executable] + ARGS, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ''
    # past the look for a card, the program is missing
    cpu = subprocess.run(
        [sys.executable, '-c', 'import cardbench.run as CR; '
         "CR.run('plan-fused-32k', 3, 0.0, 0, device='cpu')"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert cpu.returncode != 0 and cpu.stdout == ''
    assert "No module named 'hector_torch'" in cpu.stderr

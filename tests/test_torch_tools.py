"""The port's tools (tools/torch_*.py) on the CPU at small sizes, each held
to its JAX counterpart where one computes the same record."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_ba_bench  # noqa: E402
import torch_config_probe  # noqa: E402
import torch_eval_kitti  # noqa: E402
import torch_eval_scenes  # noqa: E402
import torch_icp_bench  # noqa: E402
import torch_make_demo  # noqa: E402
import torch_parity_bench  # noqa: E402
import torch_scaling_bench  # noqa: E402
import torch_transfer_probe  # noqa: E402

torch.set_num_threads(1)

NEW_TOOLS = ("torch_eval_scenes", "torch_parity_bench", "torch_eval_kitti",
             "torch_make_demo", "torch_ba_bench", "torch_icp_bench",
             "torch_scaling_bench", "torch_config_probe",
             "torch_transfer_probe", "torch_multihost_bench")


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_tools_import_no_jax():
    mods = ", ".join(NEW_TOOLS)
    code = ("import sys; sys.modules['jax'] = None; "
            f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'tools')!r}]; "
            f"import {mods}, patchwork_tpu_torch.oracle, "
            "patchwork_tpu_torch.utils.debug; "
            "assert not any(m == 'patchwork_tpu' or m.startswith('patchwork_tpu.')"
            " for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_eval_scenes_matches_jax_tool():
    import eval_scenes

    got = torch_eval_scenes.run(4096, 1, "cpu", log=lambda m: None)
    want = eval_scenes.run(4096, 1, log=lambda m: None)
    assert got["scenes"] == want["scenes"]
    assert got["value"] == want["value"]


def test_eval_scenes_main_writes_its_record(tmp_path, capsys):
    path = tmp_path / "eval.json"
    assert torch_eval_scenes.main(["--points", "2048", "--seeds", "1",
                                   "--device", "cpu", "--json-out",
                                   str(path)]) == 0
    line = _last_json(capsys)
    assert line == json.loads(path.read_text())
    from patchwork_tpu_torch.io.synthetic import HARD_SCENES

    assert set(line["scenes"]) == set(HARD_SCENES)
    assert line["metric"] == "hard_scene_mean_iou" and line["device"] == "cpu"


def _write_sequence(tmp_path, n_frames=2, n_pts=4096):
    # SemanticKITTI layout: (N, 4) float32 scans, uint32 labels with the
    # semantic class in the low 16 bits and an instance id above
    from patchwork_tpu_torch.io.synthetic import demo_labels, demo_point_cloud

    vel, lab = tmp_path / "velodyne", tmp_path / "labels"
    vel.mkdir()
    lab.mkdir()
    for i in range(n_frames):
        pts = demo_point_cloud(n_pts, seed=100 + i)
        np.concatenate([pts, np.ones((n_pts, 1), np.float32)], axis=1) \
            .astype(np.float32).tofile(vel / f"{i:06d}.bin")
        sem = np.where(demo_labels(n_pts), 40, 10).astype(np.uint32)
        inst = (np.arange(n_pts, dtype=np.uint32) % 7) << 16
        (sem | inst).tofile(lab / f"{i:06d}.label")
    return str(vel), str(lab)


def test_eval_kitti_matches_jax_tool(tmp_path):
    import eval_kitti

    vel, lab = _write_sequence(tmp_path)
    got = torch_eval_kitti.evaluate(vel, lab, capacity=4096, device="cpu",
                                    log=lambda *a: None)
    want = eval_kitti.evaluate(vel, lab, capacity=4096, log=lambda *a: None)
    assert got["scans"] == want["scans"] == 2
    for key in ("iou", "f1", "precision", "recall"):
        assert got[key] == want[key], key


def test_eval_kitti_main_without_labels(tmp_path, capsys):
    vel, _ = _write_sequence(tmp_path)
    assert torch_eval_kitti.main([vel, "--limit", "1", "--capacity", "4096",
                                  "--device", "cpu"]) == 0
    line = _last_json(capsys)
    assert line["scans"] == 1 and "iou" not in line


def test_make_demo_panels_match_jax_tool(tmp_path, monkeypatch, capsys):
    from PIL import Image

    import make_demo

    argv = ["--points", "3000", "--size", "96", "64", "--extent", "40"]
    jax_png, port_png = tmp_path / "jax.png", tmp_path / "port.png"
    monkeypatch.setattr(sys, "argv", ["make_demo.py", *argv, "--out",
                                      str(jax_png)])
    assert make_demo.main() == 0
    assert torch_make_demo.main([*argv, "--out", str(port_png),
                                 "--device", "cpu"]) == 0
    want = np.asarray(Image.open(jax_png).convert("RGB"))
    got = np.asarray(Image.open(port_png).convert("RGB"))
    assert got.shape == want.shape
    pad, top, w, h = (torch_make_demo.PAD, torch_make_demo.LABEL_H, 96, 64)
    for i, name in enumerate(torch_make_demo.PANELS):
        x0 = pad + i * (w + pad)
        a = got[top + pad:top + pad + h, x0:x0 + w].copy()
        b = want[top + pad:top + pad + h, x0:x0 + w].copy()
        if name != "raw":
            # the JAX overlay blanks its last pixel (viz/bev.py:81-86)
            a[-1, -1] = b[-1, -1] = 0
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.any(), name
    # outside the panels: the background (the JAX tool writes the names)
    assert (got[top + pad:, :pad] == torch_make_demo.BACKGROUND).all()


def test_parity_bench_passes(capsys):
    assert torch_parity_bench.main(["--points", "4096", "--reps", "1",
                                    "--batch", "2", "--device", "cpu"]) == 0
    line = _last_json(capsys)
    assert line["ok"] and line["aliases"] == {"onehot": "scatter"}
    assert set(line["engine"]) == {"scatter", "pallas", "fused"}
    assert all(r["bits_vs_oracle"] == 0 for r in line["engine"].values())
    assert set(line["batch"]["impls"]) == {"scatter", "pallas", "fused"}
    assert line["rotation_max_err"] < 1e-4


def test_parity_bench_exits_1_on_a_mismatch(monkeypatch, capsys):
    from patchwork_tpu_torch.oracle import reference

    real = reference.filter_ground_oracle

    def flipped(points, cfg):
        ground, *rest = real(points, cfg)
        ground = ground.copy()
        ground[:7] = ~ground[:7]
        return (ground, *rest)

    monkeypatch.setattr(reference, "filter_ground_oracle", flipped)
    assert torch_parity_bench.main(["--points", "2048", "--reps", "1",
                                    "--impls", "fused", "--device",
                                    "cpu"]) == 1
    line = _last_json(capsys)
    assert not line["ok"] and line["engine"]["fused"]["bits_vs_oracle"] == 7


def test_ba_bench_keys_and_poses(capsys):
    import ba_bench
    from patchwork_tpu_torch.slam.ba import (BAProblem, ba_residuals,
                                             bundle_adjust)

    shape = dict(k=12, n_landmarks=20, obs_per_kf=8)
    arrays = torch_ba_bench.synth_arrays(**shape)
    jprob = ba_bench.synth_problem(12, 20, 8)
    for key, a in arrays.items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jprob, key)))
    assert torch_ba_bench.main(["--k", "12", "--landmarks", "20",
                                "--obs-per-kf", "8", "--iters", "2",
                                "--reps", "1", "--device", "cpu"]) == 0
    line = _last_json(capsys)
    assert {"build_s", "first_call_s", "solve_ms_events", "value", "seg",
            "mean_abs_residual_before",
            "mean_abs_residual_after"} <= set(line)
    assert line["seg"] == "sort" and line["obs"] == 96
    prob = BAProblem.from_numpy(*arrays.values(), device="cpu")
    out = bundle_adjust(prob, iters=2, solver="pcg", seg_impl="sort")
    assert line["mean_abs_residual_after"] == float(
        ba_residuals(out.poses, out.points, prob).abs().mean())
    assert line["mean_abs_residual_after"] < line["mean_abs_residual_before"]


def test_ba_bench_margin_arm(capsys):
    assert torch_ba_bench.main(["--margin", "--k", "12", "--landmarks", "20",
                                "--obs-per-kf", "8", "--iters", "2",
                                "--margin-ranks", "2", "--device",
                                "cpu"]) == 0
    line = _last_json(capsys)
    assert set(line["margins"]) == {"sort", "scatter"}
    assert all(0 <= v < 1e-3 for m in line["margins"].values()
               for v in m.values())


def test_icp_bench_keys(capsys):
    import icp_bench

    obst, gnd = torch_icp_bench.synth_features(4, 64, 32)
    j_obst, j_gnd = icp_bench.synth_features(4, 64, 32)
    np.testing.assert_array_equal(obst, j_obst)
    np.testing.assert_array_equal(gnd, j_gnd)
    assert torch_icp_bench.main(["--frames", "4", "--pair-chunk", "2",
                                 "--reps", "1", "--device", "cpu"]) == 0
    line = _last_json(capsys)
    assert {"first_call_s", "kernel_chunk_ms", "solve_pairs_s_per_rep",
            "whole_pass_overhead_s", "e2e_icp_s", "value"} <= set(line)
    assert line["sanity_moved"] and line["pairs_timed"] == 3


def test_probes_on_the_cpu(capsys):
    assert torch_config_probe.main(["--points", "2048", "--batch", "2",
                                    "--reps", "1", "--exact",
                                    "--device", "cpu"]) == 0
    line = _last_json(capsys)
    assert line["metric"] == "config_probe_scans_per_s" and not line["fast"]
    assert line["value"] > 0
    assert torch_transfer_probe.main(["--points", "2048", "--batch", "2",
                                      "--reps", "1", "--device", "cpu"]) == 0
    line = _last_json(capsys)
    assert line["resident_ms"] > 0 and line["value"] is None


def test_multihost_scaling_arm_over_gloo():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_multihost_bench.py"),
         "--scaling", "--scaling-procs", "1,2", "--device", "cpu",
         "--points", "1024", "--bench-reps", "2", "--box-s", "0.5",
         "--ba-obs", "512", "--ba-steps", "1"],
        capture_output=True, text=True, timeout=90, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["procs"] == [1, 2] and line["value"] > 0
    assert all(v > 0 for v in line["ba_comm_efficiency"])


def test_scaling_bench_dp_and_sp(capsys):
    assert torch_scaling_bench.main(["--points", "1024", "--max-ranks", "2",
                                     "--reps", "1", "--device", "cpu"]) == 0
    line = _last_json(capsys)
    assert set(line["ms_per_step"]) == {"1", "2"}
    assert line["efficiency"]["1"] == 1.0
    assert torch_scaling_bench.main(["--points", "1024", "--max-ranks", "1",
                                     "--sp", "2", "--reps", "1",
                                     "--device", "cpu"]) == 0
    assert _last_json(capsys)["sp"] == 2

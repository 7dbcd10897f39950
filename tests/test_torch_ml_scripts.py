"""The port's entry points and scripts against the JAX package's:
``dynslam_tpu_torch.entry.entry`` against ``__graft_entry__.entry``, the
checkpoint of ``scripts/train_dispnet.py`` loaded by JAX's model, and the
dumps of ``scripts/preprocess_sequence.py`` against the JAX script's (run
in a subprocess, as ``tests/test_preprocess_sequence.py`` runs it).

Tolerances: ``entry``'s map has JAX's block layout exactly and its packed
words within ``assert_map_close`` (test_torch_fused.py); its render holds
hits on >= 99.9% of the pixels in agreement and a median |depth gap| <=
1e-5 m where both hit (the dense tracer's bounds, test_torch_dense_
raycast.py). ``train_dispnet``: JAX's model on the pickled weights equals
the port's module on them to 1e-5 px (test_torch_models.py's bound).
``preprocess_sequence``: every file byte for byte.
"""

import filecmp
import os
import pickle
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynslam_tpu.models import dispnet as jd
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.models import dispnet as td
from test_torch_fused import assert_map_close
from torch_threads import threads

torch_threads = threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_HIT_AGREE, MAX_MEDIAN_GAP_M = 0.999, 1e-5
FWD_ATOL = 1e-5
#: the preprocessing folder: tests/test_preprocess_sequence.py's size
W, H, N_FRAMES = 96, 64, 3


def test_entry_matches_jax_entry():
    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    from dynslam_tpu_torch.entry import entry

    jfn, jargs = g.entry()
    jstate, jdepth = jax.jit(jfn)(*jargs)
    fn, args = entry("cpu")
    for got, want in zip(args[1:5], jargs[1:5]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    state, depth = fn(*args)
    for k in ("valid", "block_coords"):
        np.testing.assert_array_equal(getattr(state, k).numpy(),
                                      np.asarray(getattr(jstate, k)))
    used = np.nonzero(np.asarray(jstate.valid))[0]
    assert used.size > 100
    assert_map_close(np.asarray(jstate.tsdf_w)[used],
                     state.tsdf_w.numpy()[used])
    got, want = depth.numpy(), np.asarray(jdepth)
    hits, jhits = got > 0, want > 0
    assert (hits == jhits).mean() >= MIN_HIT_AGREE
    both = hits & jhits
    assert both.mean() > 0.5
    assert np.median(np.abs(got[both] - want[both])) <= MAX_MEDIAN_GAP_M


def test_train_dispnet_checkpoint_loads_in_jax(tmp_path, capsys):
    from dynslam_tpu_torch.scripts import train_dispnet

    out = tmp_path / "ckpt"
    train_dispnet.main(["--cpu", "--steps", "2", "--batch", "2", "--width",
                        "48", "--height", "32", "--out", str(out)])
    printed = capsys.readouterr().out
    assert "[train] step    1 loss" in printed
    assert "saved checkpoint" in printed
    with open(out / "params.pkl", "rb") as f:
        ckpt = pickle.load(f)
    assert ckpt["max_disparity"] == 48.0
    model = td.create_model(max_disparity=48.0)
    model.load_state_dict(convert.flax_to_state_dict(ckpt["params"]))
    init = td.init_params(td.create_model(), torch.Generator().manual_seed(0))
    assert any(not torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), init.state_dict().values()))
    rng = np.random.default_rng(3)
    left, right = (rng.uniform(0, 255, (1, 32, 48, 3)).astype(np.float32)
                   for _ in range(2))
    want = np.asarray(jax.jit(jd.create_model(max_disparity=48.0).apply)(
        jax.tree_util.tree_map(jnp.asarray, ckpt["params"]), left, right))
    with torch.no_grad():
        got = model(*(torch.from_numpy(x).permute(0, 3, 1, 2)
                       for x in (left, right))).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


def test_preprocess_sequence_equals_jax_script(tmp_path):
    """Depth XML, disparity PFM and the MNC dumps of a random-init SegNet
    (a low threshold gives components to dump) on the same raw folder."""
    from dynslam_tpu.io.synthetic import write_kitti_sequence
    from dynslam_tpu_torch.models import segnet
    from dynslam_tpu_torch.scripts import preprocess_sequence

    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    write_kitti_sequence(jax_root, num_frames=N_FRAMES, width=W, height=H,
                         with_dynamic=True, write_elas_xml=False,
                         write_dispnet=False)
    shutil.rmtree(os.path.join(jax_root, "seg_image_2"))
    shutil.copytree(jax_root, port_root)
    params = str(tmp_path / "segnet.msgpack")
    segnet.save_params(params, segnet.init_params(
        segnet.create_model(), torch.Generator().manual_seed(0)))
    flags = ["--max_disparity", "64", "--seg_params", params,
             "--seg_threshold", "0.35", "--min_detection_size", "8", "--cpu"]
    r = subprocess.run(
        [sys.executable, "scripts/preprocess_sequence.py", "--dataset_root",
         jax_root] + flags, capture_output=True, text=True, cwd=REPO,
        timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    preprocess_sequence.main(["--dataset_root", port_root] + flags)

    files = []
    for dirpath, _, names in os.walk(jax_root):
        rel = os.path.relpath(dirpath, jax_root)
        files += [os.path.join(rel, n) for n in names]
    port_files = {os.path.relpath(os.path.join(d, n), port_root)
                  for d, _, ns in os.walk(port_root) for n in ns}
    assert port_files == {os.path.normpath(f) for f in files}
    written = [f for f in files if f.split(os.sep)[0] in (
        "precomputed-depth", "precomputed-depth-dispnet", "seg_image_2")]
    masks = [f for f in written if f.endswith(".mask.txt")]
    assert len(written) >= 3 * N_FRAMES and masks
    _, mismatch, errors = filecmp.cmpfiles(jax_root, port_root, files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)

"""``parallel/sharding.py`` and ``parallel/launch.py`` on gloo ranks (one
process a rank, torch at 1 thread each): the sharded DispNet-lite step
against the single-device step, the mesh layout, the sharded apply, the
all-gather trap, and ``dryrun_multichip(2, device="cpu")``.

Tolerances: the sharded and unsharded steps reduce in another order
(gradients summed over ranks, channels convolved apart), so the losses
agree to rel 1e-5 and the parameters after 3 Adam steps to 2 * lr * 3 at
most (Adam turns a gradient near 0 into a step of ~lr whose sign is the
gradient's, so a sign flip costs up to 2 lr a step), with the median
|difference| <= 1e-6 (measured: max 7.2e-7, median 0 at (data 2, model
2)).
"""

import numpy as np
import pytest

import torch_parallel_workers as pw
from dynslam_tpu_torch.parallel import launch

LOSS_RTOL = 1e-5
PARAM_MAX = 2 * pw.LR * pw.STEPS
PARAM_MEDIAN = 1e-6


@pytest.fixture(scope="module")
def single():
    return pw.single_device_steps()


@pytest.fixture(scope="module", params=[(4, 2), (4, 1)],
                ids=["data2xmodel2", "data4xmodel1"])
def sharded(request):
    world, model_axis = request.param
    return model_axis, launch.spawn(pw.sharded_steps, world, "cpu",
                                    model_axis)


def test_sharded_step_equals_single_device(single, sharded):
    """The global masked mean: the ranks' valid masks differ (20% to 90%
    valid samples), which a mean of per-rank means would get wrong."""
    _, results = sharded
    for r in results:
        np.testing.assert_allclose(r["losses"], single["losses"],
                                   rtol=LOSS_RTOL)
        diff = np.concatenate([np.abs(r["params"][k] - v).ravel()
                               for k, v in single["params"].items()])
        assert diff.max() <= PARAM_MAX, diff.max()
        assert np.median(diff) <= PARAM_MEDIAN, np.median(diff)


def test_mean_of_rank_means_is_another_loss():
    """What the test above guards: on this batch the mean of the two data
    ranks' own masked means is not the global masked mean."""
    import torch

    from dynslam_tpu_torch.models.dispnet import disparity_loss

    model, b = pw.dispnet_model(), pw.dispnet_batch()
    with torch.no_grad():
        whole = float(disparity_loss(model, b["left"], b["right"],
                                     b["disparity"], b["valid"]))
        halves = [float(disparity_loss(model, *(b[k][i:i + 2] for k in (
            "left", "right", "disparity", "valid")))) for i in (0, 2)]
    assert abs(np.mean(halves) - whole) > 100 * LOSS_RTOL * whole


def test_mesh_layout(sharded):
    """("data", "model") in row-major rank order; the batch splits over
    "data"; the >= 64-channel convs split over "model"."""
    model_axis, results = sharded
    data_axis = len(results) // model_axis
    full = sum(v.size for v in results[0]["params"].values())
    for rank, r in enumerate(results):
        assert r["mesh"] == {"data": data_axis, "model": model_axis}
        assert (r["data_rank"], r["model_rank"]) == divmod(rank, model_axis)
        assert r["local_batch"] == pw.BATCH // data_axis
        if model_axis == 1:
            assert r["local_numel"] == full
        else:
            split = sum(v.size for k, v in results[0]["params"].items()
                        if v.shape[0] >= 64)
            assert r["local_numel"] == full - split + split // model_axis


def test_sharded_apply(sharded):
    """Data-parallel inference returns the whole batch on every rank, as
    one module holding the gathered parameters computes it (to float
    noise: the split convs sum their products in another order)."""
    _, results = sharded
    for r in results:
        assert r["disp"].shape == (pw.BATCH, pw.H, pw.W)
        np.testing.assert_allclose(r["disp"], r["disp_whole"], rtol=1e-5,
                                   atol=1e-4)


def test_library_all_gather_scales_gradients():
    """``torch.distributed.nn.functional.all_gather`` sums the group's
    output gradients: with a replicated loss every input gradient comes
    out multiplied by the group size (here 2), which is why the sharded
    convs gather with a backward that takes the rank's own slice."""
    grads = launch.spawn(pw.library_gather_grad, 2, "cpu")
    for g in grads:
        np.testing.assert_array_equal(g, np.full((2, 3), 2.0))


def test_dryrun_multichip_cpu(capsys):
    from dynslam_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(2, device="cpu")
    assert out["line"].startswith("dryrun_multichip OK: mesh=({'data': 1, "
                                  "'model': 2})")
    assert np.isfinite(out["loss"])
    assert out["metrics"].shape == (2, 2, 2)
    assert out["dyn"].shape == (2, 2, 3)
    assert (out["dyn"][-1, :, 2] > 0).all()

"""`chip_smoke.py`'s recorder of the tap-conv's step shapes, on the CPU.

`chip_smoke.tap_step_shapes` puts forward hooks on a model's MMConvs and
reads, per forward, the shape of the tap-conv each makes from the module's
input and weights; the card's timing of kernels 3 and 4 at every shape of
an MM_Net train step rests on it. Here a small MM_Net (depths (1,1,1,1),
64², CPU) is run once with `tap_conv` itself watched where the
morph-0 sample-conv (`layers.row_sample_conv`) calls it: the hooks must record
as many calls as the model's own count and exactly the (B, H, W, C, F, K,
dtype) that `tap_conv` was given.
"""

import numpy as np
import torch

import chip_smoke
from mm_unet_tpu_torch.models import give_model
from mm_unet_tpu_torch.models import layers


def test_tap_step_shapes_match_the_tap_conv_calls(monkeypatch):
    model = give_model("MM_Net", device="cpu", generator=torch.Generator().manual_seed(0),
                       mamba_dtype=None, depths=(1, 1, 1, 1), num_slices_list=(4, 4, 4, 4))
    seen: dict = {}
    plain = layers.tap_conv

    def watched(feat, y, kernel, bias, shifts):
        b, h, w, c = feat.shape
        key = (b, h, w, c, kernel.shape[-1], kernel.shape[0], str(feat.dtype)[6:])
        seen[key] = seen.get(key, 0) + 1
        return plain(feat, y, kernel, bias, shifts)

    monkeypatch.setattr(layers, "tap_conv", watched)
    shapes, hooks = chip_smoke.tap_step_shapes(model)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 64, 64), np.float32))
    with torch.no_grad():
        model.eval()(x)
    for h in hooks:
        h.remove()
    assert sum(shapes.values()) == model.kernel_launches_per_forward()["tap_conv"]
    assert shapes == seen
    with torch.no_grad():  # the hooks are gone
        model(x)
    assert sum(shapes.values()) == model.kernel_launches_per_forward()["tap_conv"]


def test_tap_step_shapes_cover_um_net_dsconvs(monkeypatch):
    """The same recorder on UM_Net, whose tap-convs are its 16 DSConvs'."""
    model = give_model("UM_Net", device="cpu", generator=torch.Generator().manual_seed(0))
    seen: dict = {}
    plain = layers.tap_conv

    def watched(feat, y, kernel, bias, shifts):
        b, h, w, c = feat.shape
        key = (b, h, w, c, kernel.shape[-1], kernel.shape[0], str(feat.dtype)[6:])
        seen[key] = seen.get(key, 0) + 1
        return plain(feat, y, kernel, bias, shifts)

    monkeypatch.setattr(layers, "tap_conv", watched)
    shapes, hooks = chip_smoke.tap_step_shapes(model)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 3, 64, 64), np.float32))
    with torch.no_grad():
        model.eval()(x)
    for h in hooks:
        h.remove()
    assert sum(shapes.values()) == model.kernel_launches_per_forward()["tap_conv"] == 16
    assert shapes == seen

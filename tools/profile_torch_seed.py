"""Where a seed's time goes, by part, on one NVIDIA card.

    python tools/profile_torch_seed.py [--net deeplab|schp]

`--net deeplab` (the default) runs the port's DeepLab seed (`agents/binseg.py:SegAgent`, seeded
weights: the time does not depend on them) on a seeded 544x960 work frame,
the 12 crops of 513x513 of the shipped grid and flip TTA, TF32 off, and
times with CUDA events (`utils/timing.py:cuda_ms`), in float32 and
bfloat16:

1. the whole `predict_mask_impl` call on one frame, and on 8 frames (the
   seed step of `run_segmented` with S = 8 when every segment seeds);
2. the net's three parts on one frame's 12 crops, in the memory layout the
   net gives them (`models/precision.py:net_input`): the dilated ResNet-50
   trunk, ASPP and the V3+ decoder, beside their operations (counted on
   the meta device) and the rate they reach.

`--net schp` runs bg mode's SCHP seed (`agents/binseg.py:HumanSegAgent`,
seeded weights) on the same frames, one 473x473 crop a frame, likewise:
the whole call on 1 and 8 frames, then the trunk (the stem and the four
stages) and the heads (PSP, decoder, edge, fusion) on one crop in both
memory layouts, NCHW and channels-last; the net itself runs the one
`net_input` gives its dtype.

Needs a card: it exits non-zero without one.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from video_unscreen_tpu_torch.utils.timing import cuda_ms  # noqa: E402
from video_unscreen_tpu_torch.agents.binseg import (  # noqa: E402
    HumanSegAgent, SegAgent, _crop_grid)
from video_unscreen_tpu_torch.models.deeplab import build_deeplab  # noqa
from video_unscreen_tpu_torch.models.human_parse import \
    SCHPHumanParser  # noqa: E402
from video_unscreen_tpu_torch.models.precision import net_input  # noqa: E402
from video_unscreen_tpu_torch.ops.geometry import (imnormalize,  # noqa: E402
                                                    resize_nchw)

WORK_HW = (544, 960)
CROP = 513


def parts(model, x):
    """(name, fn, inputs) of the trunk, ASPP and decoder on crop batch x,
    each part's inputs computed here, once."""
    feats = model.backbone(x)
    low_in, high = feats["c1"], feats["c4"]
    aspp = model.aspp(high)

    def decoder(low_in, aspp):
        low = F.relu(model.project_bn(model.project_conv(low_in)))
        out = resize_nchw(aspp, low.shape[-2:])
        out = F.relu(model.cls_bn(model.cls_conv(torch.cat([low, out], 1))))
        return resize_nchw(model.cls_out(out), x.shape[-2:])

    return [("trunk", model.backbone, (x,)), ("aspp", model.aspp, (high,)),
            ("decoder", decoder, (low_in, aspp))]


def schp_parts(model, x):
    """(name, fn, inputs) of SCHP's trunk and heads on crop batch x."""
    return [("trunk", model.trunk, (x,)),
            ("heads", model.heads, tuple(model.trunk(x)))]


def part_flops(parts_of, build, x_shape):
    from torch.utils.flop_counter import FlopCounterMode
    out = {}
    with torch.device("meta"):
        for name, fn, args in parts_of(build().eval(), torch.zeros(x_shape)):
            with FlopCounterMode(display=False) as counter:
                fn(*args)
            out[name] = counter.get_total_flops()
    return out


def profile_deeplab(batch):
    frame = batch[0]
    norm = imnormalize(frame)
    crops = torch.stack([
        norm[y:y + CROP, x:x + CROP].flip(1) if flipped
        else norm[y:y + CROP, x:x + CROP]
        for y, x, flipped in _crop_grid(*WORK_HW, CROP, CROP, 0.5, True)])
    crops = crops.permute(0, 3, 1, 2)
    flops = part_flops(parts, build_deeplab, crops.shape)
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        seg = SegAgent(device="cuda", dtype=dt)
        reps = 1 if dt == torch.float32 else 5
        for n in (1, 8):
            ms = cuda_ms(lambda: seg.predict_mask_impl(batch[:n]), reps, 3)
            print(f"  seed {name} on {n} frame(s) ({12 * n} crops): "
                  f"{ms:.3f} ms", flush=True)
        x = net_input(crops, dt)
        for part, fn, args in parts(seg.model, x):
            ms = cuda_ms(lambda: fn(*args), reps, 3)
            print(f"  {name} {part}: {ms:.3f} ms, {flops[part] / 1e12:.4f} "
                  f"TFLOP ({flops[part] / ms / 1e9:.2f} TFLOP/s)", flush=True)


def profile_schp(batch):
    seg = {"f32": HumanSegAgent(device="cuda", seed=0),
           "bf16": HumanSegAgent(device="cuda", seed=0,
                                 dtype=torch.bfloat16)}
    crop = seg["f32"].input_size
    crops = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (1, 3) + crop).astype(np.float32)).cuda()
    flops = part_flops(schp_parts, SCHPHumanParser, crops.shape)
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for n in (1, 8):
            ms = cuda_ms(lambda: seg[name].predict_mask_impl(batch[:n]), 5,
                         3)
            print(f"  SCHP {name} on {n} frame(s) ({crop[0]}x{crop[1]} "
                  f"crops): {ms:.3f} ms", flush=True)
        shipped = net_input(crops, dt).is_contiguous(
            memory_format=torch.channels_last)
        for fmt, mf in (("NCHW", torch.contiguous_format),
                        ("channels-last", torch.channels_last)):
            x = crops.to(dtype=dt, memory_format=mf)
            tag = " (shipped)" if shipped == (fmt == "channels-last") else ""
            for part, fn, args in schp_parts(seg[name].model, x):
                ms = cuda_ms(lambda: fn(*args), 5, 3)
                print(f"  {name} {fmt}{tag} {part}: {ms:.3f} ms, "
                      f"{flops[part] / 1e12:.4f} TFLOP "
                      f"({flops[part] / ms / 1e9:.2f} TFLOP/s)", flush=True)


@torch.inference_mode()
def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--net", choices=("deeplab", "schp"), default="deeplab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_seed: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    batch = torch.from_numpy(rng.uniform(0, 255, (8,) + WORK_HW + (3,)).astype(
        np.float32)).cuda()
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; {args.net} seed at "
          f"{WORK_HW[0]}x{WORK_HW[1]}, TF32 off", flush=True)
    (profile_schp if args.net == "schp" else profile_deeplab)(batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())

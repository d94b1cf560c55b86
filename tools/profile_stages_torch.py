"""Device time of stages alone at the work geometry (544x960), on one
NVIDIA card: the always-on non-matmul stages of `tools/profile_stages.py`
that no other timing tool of the port times alone, each the median over
rounds of CUDA-event times (`utils/timing.py:cuda_ms`).

    python tools/profile_stages_torch.py [--hw 544,960] [--ops a,b]
        [--reps 20]

Stages (JAX's names):
- `cc_stats_ds`: object removal's per-object sums and keep decision at
  half resolution, given the labels (the labeling itself is K3,
  `tools/time_torch_flood.py`);
- `i420_to_bgr`: the I420 wire's decode on the device;
- `regionfill_200`, `regionfill_50`: the CG regionfill of one plane at
  half resolution, at most 200 and 50 iterations, cold;
- `regionfill3_cold`, `regionfill3_warm`: fused bg's background solve of
  three channels in one batch, cold and warm-started from its own
  solution (as consecutive frames run);
- `pack_plane`: the host fetch's bit-pack of one alpha plane
  (`ops/wirepack.py`; bg packs a (1088, 960) stack), which JAX's tool
  predates.
Timed elsewhere, so left out: `remove_invalid_ds`, `trimap`,
`trimap_withbg`, `color_correct` and the seeds, STM and matting
(`tools/profile_torch_{green,bg,fused_bg,seed}.py` spans and calls),
`cc_flood_ds` (K3, `tools/time_torch_flood.py`), `dilate_k3_i5` and
`dilate_k4_i2` (K1 and K2 at every path call, `chip_smoke.py`).

Prints one line a stage, ms, then one JSON line with every figure and the
card's name. Needs a card: it exits 2 without one.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def stages(h: int, w: int, dev):
    """(name, zero-argument callable) of each stage on seeded inputs."""
    from video_unscreen_tpu_torch.ops.color import yuv420_to_bgr
    from video_unscreen_tpu_torch.ops.connected import (
        connected_components_compact, score_map)
    from video_unscreen_tpu_torch.ops.geometry import resize
    from video_unscreen_tpu_torch.ops.morphology import dilate
    from video_unscreen_tpu_torch.ops.regionfill import (regionfill,
                                                         regionfill_solve,
                                                         solve_shape)
    from video_unscreen_tpu_torch.ops.wirepack import pack_plane

    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = np.zeros((h, w), np.float32)
    alpha[((yy - h // 2) ** 2 / (h * 0.3) ** 2
           + (xx - w // 3) ** 2 / (w * 0.15) ** 2) < 1.0] = 255.0
    alpha[((yy - h // 4) ** 2 / 900 + (xx - 2 * w // 3) ** 2 / 400)
          < 1.0] = 255.0
    alpha[rng.rand(h, w) < 0.001] = 255.0
    alpha_t = torch.from_numpy(alpha).to(dev)
    frame = torch.from_numpy(rng.rand(h, w, 3).astype(np.float32)
                             * 255.0).to(dev)
    score = torch.from_numpy(score_map(h, w)).to(dev)

    lo = (h // 2, w // 2)
    a_lo = resize(alpha_t, lo, "nearest")
    s_lo = resize(score, lo, "nearest")
    _, cid = connected_components_compact(a_lo)

    def cc_stats():
        flat = cid.reshape(-1).to(torch.int64)
        n = lo[0] * lo[1] + 1
        ones = (flat > 0).to(torch.float32)
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        area = zeros.index_add(0, flat, ones)
        sal = zeros.index_add(0, flat, s_lo.reshape(-1) * ones)
        cons = zeros.index_add(0, flat, (a_lo.reshape(-1) / 255.0) * ones)
        saliency = sal / float(lo[0] * lo[1])
        consensus = cons / area.clamp_min(1.0)
        valid = (area >= 25) & (((saliency > 0.005) & (consensus > 0.5))
                                | (saliency > 0.05))
        valid[0] = False
        return torch.where(valid[flat].reshape(lo), a_lo, 0.0)

    i420 = torch.from_numpy(rng.randint(0, 255, (1, h * 3 // 2, w),
                                        dtype=np.uint8)).to(dev)
    hole = dilate(torch.where(alpha_t > 128, 255.0, 0.0), 3, 2)
    planes = frame.permute(2, 0, 1).contiguous()
    sol = {"x": torch.zeros((3,) + solve_shape(h, w, 0.5), device=dev)}

    def fill3(warm):
        x0 = sol["x"] if warm else None
        _, s, _ = regionfill_solve(planes, hole[None].expand(3, h, w), 0.5,
                                   cg_iters=200, x0=x0)
        sol["x"] = s

    soft = alpha_t.clone()
    soft[(alpha_t > 0) & (torch.from_numpy(rng.rand(h, w) < 0.03)
                          .to(dev))] = 128.0
    both = torch.cat([soft, soft]).to(torch.uint8)
    return (
        ("cc_stats_ds", cc_stats),
        ("i420_to_bgr", lambda: yuv420_to_bgr(i420)),
        ("regionfill_200", lambda: regionfill(frame[..., 0], alpha_t, 0.5,
                                              200)),
        ("regionfill_50", lambda: regionfill(frame[..., 0], alpha_t, 0.5,
                                             50)),
        ("regionfill3_cold", lambda: fill3(False)),
        ("regionfill3_warm", lambda: fill3(True)),
        ("pack_plane", lambda: pack_plane(soft)),
        ("pack_plane_bg", lambda: pack_plane(both)),
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--hw", type=str, default="544,960")
    parser.add_argument("--ops", type=str, default="all")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_stages_torch: needs an NVIDIA card with CUDA",
              file=sys.stderr)
        sys.exit(2)
    from video_unscreen_tpu_torch.utils.device import resolve_device
    from video_unscreen_tpu_torch.utils.timing import cuda_ms
    dev = resolve_device("cuda")
    h, w = (int(v) for v in args.hw.split(","))
    sel = None if args.ops == "all" else set(args.ops.split(","))
    out = {}
    with torch.inference_mode():
        for name, fn in stages(h, w, dev):
            if sel and name not in sel:
                continue
            out[name] = cuda_ms(fn, args.reps)
            print(f"{name:24s} {out[name]:8.4f} ms")
    print(json.dumps({"profile_stages": out, "hw": [h, w],
                      "card": torch.cuda.get_device_name(0)}))
    return out


if __name__ == "__main__":
    main()

"""The readings that the limits of the comparison are set from.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,... \
        --control-seeds 21,22,23 [--out readings.json]

For each seed of ``--seeds`` this builds the cell as a run does and judges
``checked`` requests that the program serves (the lower readings).  For
each of ``--control-seeds`` it judges the control in the program's place
on the same requests (the upper readings): the reference one precision
below what the configuration states in the stages the program has no
lower path for (the flow in TF32, the rollout on scaled fp8 operands, the
camera and the raster in bfloat16) and, for the VUNet, the program's own
int8 path (``quant: int8``) on the control's stickmen.  The benchmark's
runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def served(cell, seed, device):
    """(params, pool, outputs of the pool's first ``checked`` requests)."""
    from benchmark import harness
    from benchmark.traffic import make_pool
    from benchmark.weights import make_params

    cfg, traffic = cell.config, cell.traffic
    params = make_params(cfg, seed, device)
    pool = make_pool(cfg, traffic, seed, device)
    pipe, _ = harness.program(cfg, params, device)
    n = min(int(traffic["checked"]), len(pool))
    outs = []
    for r in pool[:n]:
        outs.append(pipe.generate(r["z"], r["x_start"], r["app"],
                                  r["extrinsics"], r["intrinsics"],
                                  r["image_size"],
                                  length=int(traffic["frames"]),
                                  use_flow=True, eps=r["eps"]))
    return params, pool, outs


def int8_vunet(cfg, params):
    """The program's VUNet with its int8 path switched on, on the same
    weights."""
    import torch
    from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
        vunet_from_config)

    from benchmark.harness import run_config
    from benchmark.reference import spec as S
    from benchmark.weights import subset

    vunet = vunet_from_config(run_config(cfg), S.variant(cfg),
                              dtype=torch.bfloat16, remat=False,
                              rnb_impl=cfg["serving"]["rnb_impl"],
                              quant="int8", device="meta")
    vunet.load_state_dict(subset(params, S.vunet_spec(cfg)), strict=True,
                          assign=True)
    return vunet.eval()


def control_outputs(cell, params, request, vunet8):
    """The control's outputs for one request."""
    import torch

    from benchmark.reference import model as R
    from benchmark.yardstick import chunk_size

    cfg, traffic = cell.config, cell.traffic
    T = int(traffic["frames"])
    size = int(cfg["synthesis_net"]["spatial_size"])
    world = R.poses(params, cfg, request["z"], request["x_start"], T,
                    low=True)
    kp = R.project(world, request["extrinsics"], request["intrinsics"],
                   request["image_size"], size, low=True)
    stick = R.stickman_input(R.raster(cfg, kp, low=True))
    with torch.inference_mode():
        means, _ = vunet8.encode_means(request["app"], request["eps"])
        V = stick.shape[0]
        flat = stick.reshape((V * T,) + stick.shape[2:])
        tiled = [torch.repeat_interleave(m, T, dim=0) for m in means]
        cs, _ = chunk_size(V * T, int(cfg["serving"]["vunet_chunk"]))
        frames = torch.cat([vunet8.transfer_cached(
            [m[s:s + cs] for m in tiled], flat[s:s + cs])
            for s in range(0, V * T, cs)])
    return {"poses_3d": world, "keypoints_2d": kp, "stickman": stick,
            "frames": frames.reshape((V, T) + frames.shape[1:])}


def readings(cell, seeds, control_seeds, device, log=None):
    import torch

    from benchmark import check

    log = log or sys.stderr

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    out = {"program": {}, "control": {}, "reference_s": []}
    for seed in sorted(set(seeds) | set(control_seeds)):
        params, pool, outs = served(cell, seed, device)
        sync()
        if seed in seeds:
            rows = []
            for r, o in zip(pool, outs):
                t0 = time.perf_counter()
                rows.append(check.judge(params, cell.config, cell.traffic,
                                        r, o))
                sync()
                out["reference_s"].append(time.perf_counter() - t0)
            out["program"][seed] = check.worst(rows)
            print(f"program seed {seed}: {out['program'][seed]}", file=log)
        del outs
        if seed in control_seeds:
            vunet8 = int8_vunet(cell.config, params)
            rows = [check.judge(params, cell.config, cell.traffic, r,
                                control_outputs(cell, params, r, vunet8))
                    for r in pool[:int(cell.traffic["checked"])]]
            out["control"][seed] = check.worst(rows)
            print(f"control seed {seed}: {out['control'][seed]}", file=log)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = [int(s) for s in args.control_seeds.split(",")]
    result = readings(cell, seeds, control_seeds, torch.device("cuda", 0))
    result.update(workload=args.workload,
                  device=torch.cuda.get_device_name(0))
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

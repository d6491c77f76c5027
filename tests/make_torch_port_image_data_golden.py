"""Write tests/golden/torch_port_image_data_small.npz: the JAX package's
image datasets, Inception, IS, FID and keypoint crop on small inputs, with
the files and seeds to rebuild those inputs.

    JAX_PLATFORMS=cpu python tests/make_torch_port_image_data_golden.py

``chip_smoke.py`` phase [19] writes the same trees from this file, holds
the PyTorch port's items, Inception, IS, FID and crop on the GPU against
it and needs no JAX to read it; ``tests/test_torch_inception_metrics.py``
checks that the file still equals a live JAX run.

Keys:
  * ``df/jpeg``, ``df/offsets``, ``df/joints``, ``df/train``: a DeepFashion
    ``index.p`` tree of 8 JPEGs 48 px a side (``img_<i>.jpg``);
  * ``h36m/jpeg``, ``h36m/offsets``, ``h36m/<column>``: a Human3.6M tree,
    its JPEG frames and the columns of its ``annot_export.h5``;
  * ``items/<name>/<key>``: the JAX dataset's items of
    ``torch_port_image_data.GOLDEN_DATASETS``, collated, images as uint8
    levels;
  * ``inception/{seed,input_seed,features,logits}``: the JAX network with
    the weights of ``seeded_inception(seed)`` on ``inception_inputs(
    input_seed)`` resized to 128 px;
  * ``is/value`` (of those logits), ``fid/{seed,value}`` (of two seeded
    feature sets), ``crop/{seed,out}`` (``bounding_box_batch``).
"""
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import torch_port_image_data as TI  # noqa: E402

OUT = os.path.join(HERE, "golden", "torch_port_image_data_small.npz")
INCEPTION_SEED, INPUT_SEED, FID_SEED, CROP_SEED = 11, 12, 13, 14


def packed(jpegs):
    return (np.frombuffer(b"".join(jpegs), np.uint8),
            np.cumsum([0] + [len(j) for j in jpegs]))


def jax_items(trees):
    from behavior_driven_video_synthesis_tpu.data import get_dataset
    from behavior_driven_video_synthesis_tpu.data.loader import collate

    out = {}
    for name, dataset, kw, ids in TI.GOLDEN_DATASETS:
        root = trees["h36m" if dataset == "human3.6m" else "df"]
        ds = get_dataset({"dataset": dataset})(None, list(TI.KEYS), (0, 0),
                                               datapath=root, **kw)
        for k, v in TI.golden_items(collate([ds[i] for i in ids])).items():
            out[f"items/{name}/{k}"] = v
    return out


def jax_metrics():
    import jax.numpy as jnp

    from behavior_driven_video_synthesis_tpu.metrics import (
        fid_from_features, inception_score_from_logits)
    from behavior_driven_video_synthesis_tpu.models.inception import (
        InceptionV3Features)
    from behavior_driven_video_synthesis_tpu.utils import bounding_box_batch
    from behavior_driven_video_synthesis_tpu_torch.models import convert

    variables = jax.tree_util.tree_map(jnp.asarray, convert.inception_to_flax(
        TI.seeded_inception(INCEPTION_SEED).state_dict()))
    x = jnp.asarray(TI.inception_inputs(INPUT_SEED))
    x = jax.image.resize(x, (x.shape[0], 128, 128, 3), "bilinear")
    feats, logits = InceptionV3Features(with_logits=True).apply(variables, x)
    kps, imgs = TI.crop_inputs(CROP_SEED)
    return {
        "inception/seed": np.int64(INCEPTION_SEED),
        "inception/input_seed": np.int64(INPUT_SEED),
        "inception/features": np.asarray(feats),
        "inception/logits": np.asarray(logits),
        "is/value": np.float64(inception_score_from_logits(
            np.asarray(logits))[0]),
        "fid/seed": np.int64(FID_SEED),
        "fid/value": np.float64(fid_from_features(*TI.fid_features(FID_SEED))),
        "crop/seed": np.int64(CROP_SEED),
        "crop/out": np.asarray(bounding_box_batch(jnp.asarray(kps),
                                                  jnp.asarray(imgs), 16)),
    }


def golden_inputs():
    """The trees' contents: (df jpegs, index, h36m columns, h36m jpegs)."""
    df_jpegs, index = TI.index_data(8, 48, seed=21)
    cols = TI.h36m_columns()
    return df_jpegs, index, cols, TI.h36m_frames(cols)


def write_trees(root, df_jpegs, index, cols, h36m_jpegs):
    return {"df": TI.write_index_tree(os.path.join(root, "df"), df_jpegs,
                                      index),
            "h36m": TI.write_h36m_tree(os.path.join(root, "h36m"), cols,
                                       h36m_jpegs)}


def main():
    jax.config.update("jax_platforms", "cpu")
    df_jpegs, index, cols, h36m_jpegs = golden_inputs()
    out = {}
    out["df/jpeg"], out["df/offsets"] = packed(df_jpegs)
    out["df/joints"] = index["joints"]
    out["df/train"] = np.asarray(index["train"])
    out["h36m/jpeg"], out["h36m/offsets"] = packed(h36m_jpegs)
    out.update({f"h36m/{k}": v for k, v in cols.items()})
    with tempfile.TemporaryDirectory() as root:
        out.update(jax_items(write_trees(root, df_jpegs, index, cols,
                                         h36m_jpegs)))
    out.update(jax_metrics())
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {os.path.getsize(OUT) / 1024:.0f} KB, "
          f"{len(out)} arrays")


if __name__ == "__main__":
    main()

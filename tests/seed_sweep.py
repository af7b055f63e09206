"""Best F1 of a short training run over seeds, for the port and for the JAX
package, on the CPU: how often a run from scratch gets there, which a
single-seed test cannot say.

Fixtures (each the synthetic tomogram of tests/test_e2e.py):

- ``empiar``: ``doctor --empiar``'s train -> test -> pr-curve on the fixture
  of tests/test_cli.py::test_doctor_empiar_dry_run (32 x 128 x 128, 25
  particles, 4 epochs, unet_2);
- ``semiclass``: ``train --task semiclass --pn`` then ``classify-test`` as
  tests/test_semiclass.py::test_semiclass_train_pick_f1 runs them (32 x 256
  x 256, margin 70, unet_2, batch 8, no contrastive, 6 epochs of 128
  iterations, out_thresh 0.3), scored at radius 5.

One seed per line of output, ``<fixture> <impl> seed <s> best_f1 <f>``;
run several processes at once:

    JAX_PLATFORMS=cpu python tests/seed_sweep.py empiar port 317 1 2
    JAX_PLATFORMS=cpu python tests/seed_sweep.py semiclass jax 317 1

``port-from-jax`` trains the port from the JAX package's initial weights
of the same seed (``create_train_state`` saved as a JAX checkpoint
directory, read through ``--load_model``), which separates the draw of the
initial weights from the rest of the training path.
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

UNET2 = ["--order", "zxy", "--arch", "unet_2"]
EMPIAR_TRAIN = UNET2 + ["--no-compress", "--gauss", "0", "--bbox", "8",
                        "--batch_size", "4", "--no-contrastive", "--lr",
                        "1e-3", "--K", "60", "--thresh", "0.5"]
EMPIAR_TEST = UNET2 + ["--no-compress", "--gauss", "0", "--K", "60",
                       "--out_thresh", "0.0", "--cutoff_z", "2", "--nms",
                       "5", "--no-fiber"]
SEMICLASS_TRAIN = UNET2 + ["--task", "semiclass", "--pn", "--bbox", "8",
                           "--batch_size", "8", "--no-contrastive", "--lr",
                           "1e-3", "--K", "60", "--num_epochs", "6",
                           "--num_iters", "128", "--val_intervals", "-1"]
SEMICLASS_TEST = UNET2 + ["--task", "semiclass", "--bbox", "8", "--K", "60",
                          "--out_thresh", "0.3", "--cutoff_z", "2", "--nms",
                          "5", "--with_score"]


def write_volume(data, vol, df):
    from cet_pick_tpu_torch.io.mrc import write_mrc

    os.makedirs(data)
    write_mrc(os.path.join(data, "syn0.rec"), vol)
    return f"image_name\trec_path\nsyn0\t{data}/syn0.rec\n"


def jax_initial_state(task, seed, path):
    import jax

    from cet_pick_tpu.config import Config
    from cet_pick_tpu.models.detector import create_detector
    from cet_pick_tpu.train.state import create_train_state, save_checkpoint

    cfg = Config(task=task, arch="unet_2", seed=seed).finalize()
    state = create_train_state(create_detector(cfg), cfg,
                               jax.random.PRNGKey(seed),
                               np.zeros((1, 6, 32, 32), np.float32))
    save_checkpoint(path, state)


def _port_main():
    import torch

    from cet_pick_tpu_torch.__main__ import main

    torch.set_num_threads(1)
    return lambda argv: main([*argv, "--device", "cpu"])


def empiar_f1(impl, seed, root):
    from test_e2e import make_synthetic

    vol, df = make_synthetic(np.random.default_rng(11))
    data = os.path.join(root, "empiar")
    listing = write_volume(data, vol, df)
    for name in ("sample_train_explore_img.txt", "sample_val_img.txt"):
        with open(os.path.join(data, name), "w") as f:
            f.write(listing)
    for name in ("training_coordinates.txt", "val_coordinates.txt"):
        df.to_csv(os.path.join(data, name), sep="\t", index=False)
    train = EMPIAR_TRAIN + ["--seed", str(seed)]
    kw = dict(recipe="globular", root_dir=os.path.join(root, "run"),
              num_epochs=4, extra_test=EMPIAR_TEST, f1_target=0.5,
              log_fn=lambda *_: None)
    if impl == "jax":
        from cet_pick_tpu.utils.empiar import run_empiar_validation

        return run_empiar_validation(data, extra_train=train, **kw)["best_f1"]
    from cet_pick_tpu_torch.utils.empiar import run_empiar_validation

    _port_main()
    if impl == "port-from-jax":
        init = os.path.join(root, "jax_init")
        jax_initial_state("semi", seed, init)
        train += ["--load_model", init]
    return run_empiar_validation(data, extra_train=train, device="cpu",
                                 **kw)["best_f1"]


def semiclass_f1(impl, seed, root):
    import pandas as pd
    from test_e2e import make_synthetic

    from cet_pick_tpu.eval.metrics import evaluate_detections

    vol, df = make_synthetic(np.random.default_rng(317), h=256, w=256,
                             margin=70)
    data = os.path.join(root, "data")
    listing = write_volume(data, vol, df)
    for name in ("train_images.txt", "test_images.txt"):
        with open(os.path.join(data, name), "w") as f:
            f.write(listing)
    df.to_csv(os.path.join(data, "train_coords.txt"), sep="\t", index=False)
    common = ["--data_dir", data, "--root_dir", os.path.join(root, "run")]
    train = SEMICLASS_TRAIN + common + ["--seed", str(seed)]
    if impl == "jax":
        from cet_pick_tpu.__main__ import main
    else:
        main = _port_main()
        if impl == "port-from-jax":
            init = os.path.join(root, "jax_init")
            jax_initial_state("semiclass", seed, init)
            train += ["--load_model", init]
    assert main(["train", *train]) in (0, None)
    assert main(["classify-test", *SEMICLASS_TEST, *common]) in (0, None)
    out = os.path.join(root, "run", "exp", "semiclass", "default", "output",
                       "syn0.txt")
    rows = [line.split("\t") for line in open(out).read().splitlines()]
    pred = pd.DataFrame({
        "image_name": "syn0",
        "x_coord": [int(r[0]) for r in rows],
        "z_coord": [int(r[1]) for r in rows],
        "y_coord": [int(r[2]) for r in rows],
        "score": [float(r[3]) for r in rows]})
    return evaluate_detections(df, pred, radius=5)["best_f1"]


def main(argv):
    fixtures = {"empiar": empiar_f1, "semiclass": semiclass_f1}
    if len(argv) < 3 or argv[0] not in fixtures \
            or argv[1] not in ("port", "jax", "port-from-jax"):
        raise SystemExit("usage: seed_sweep.py empiar|semiclass "
                         "port|jax|port-from-jax SEED [SEED ...]")
    fixture, impl = argv[0], argv[1]
    for seed in (int(s) for s in argv[2:]):
        with tempfile.TemporaryDirectory() as root:
            f1 = fixtures[fixture](impl, seed, root)
        print(f"{fixture} {impl} seed {seed} best_f1 {f1:.6f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

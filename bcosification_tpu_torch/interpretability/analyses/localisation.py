"""Grid pointing game, the "localisation" metric (counterpart of
``bcosification_tpu/interpretability/analyses/localisation.py``).

The images of the evaluation set are sorted by the classifier's confidence
per class; n x n multi-images (``make_multi_image``, column-major cells)
are built from distinct, confidently and correctly classified classes;
each participating class is attributed (over overlapping crops in the
striding mode, for fixed-size models); the attributions are summed over
channels, smoothed, sign-flipped for ``-neg`` and clamped at 0; the score of
a class is the fraction of its positive attribution inside its own cell.
The forwards and the attributions run on the device (the GPU unless the
caller passes ``device="cpu"``); the sampling and the scoring are the JAX
package's numpy, draw for draw.
"""
from __future__ import annotations

import math
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from bcosification_tpu_torch.device import resolve_device
from bcosification_tpu_torch.interpretability.analyses.utils import Analyser
from bcosification_tpu_torch.interpretability.explanation_methods import get_explainer
from bcosification_tpu_torch.ops.pooling import avg_pool2d

__all__ = ["LocalisationAnalyser", "make_multi_image", "make_datamodule_for_config",
           "argument_parser", "main"]


def make_multi_image(n_imgs: int, dataset, offset: int = 0, fixed_indices=None):
    """(multi_img [1, sH, sW, C] numpy, targets, new_offset): the next n_imgs
    images of distinct classes from ``fixed_indices`` (from ``offset``);
    image i goes to the cell (row=i%s, col=i//s)."""
    assert n_imgs in (4, 9)
    s = int(np.sqrt(n_imgs))
    mapper = fixed_indices if fixed_indices is not None else list(range(len(dataset)))
    tgts: List[int] = []
    imgs: List[np.ndarray] = []
    i = 0
    while len(tgts) < n_imgs:
        img, tgt = dataset[mapper[i + offset]]
        i += 1
        tgt = int(tgt)
        if tgt in tgts:
            continue
        imgs.append(np.asarray(img))
        tgts.append(tgt)
    h, w, c = imgs[0].shape
    grid = np.zeros((s * h, s * w, c), imgs[0].dtype)
    for idx, im in enumerate(imgs):
        row, col = idx % s, idx // s
        grid[row * h:(row + 1) * h, col * w:(col + 1) * w] = im
    return grid[None], tgts, i + offset + 1


class LocalisationAnalyser(Analyser):
    """The grid pointing game of ``model`` over ``dataset`` (items (image
    [H, W, C], label)) on ``device``; ``run()`` gives {"localisation_metric":
    one score per attributed class}."""

    default_config = dict(
        explainer_name="Ours",
        sample_size=250,
        n_imgs=9,
        conf_thresh=0.5,
        smooth=15,
        striding="none",
        do_rescale=False,
        neg=False,
        batch_size=64,
        max_imgs=None,
    )

    def __init__(self, model, dataset, save_folder=".", device=None, **config):
        super().__init__(**config)
        self.model = model
        self.dataset = dataset
        self.save_folder = Path(save_folder)
        self.device = resolve_device(device)

    def compute_sorted_confs(self) -> Dict[int, List]:
        """{class id: [(dataset index, logit)] of its correctly classified
        images, most confident first}, dense over all class ids; read from
        and written to ``confidences.pkl`` in the save folder."""
        fp = self.save_folder / "confidences.pkl"
        if fp.exists():
            with fp.open("rb") as f:
                return pickle.load(f)
        confidences: Optional[Dict[int, List]] = None
        bs = self.config["batch_size"]
        n = len(self.dataset)
        for start in range(0, n, bs):
            batch = [self.dataset[i] for i in range(start, min(start + bs, n))]
            imgs = torch.from_numpy(np.stack([np.asarray(b[0]) for b in batch]))
            tgts = np.asarray([int(b[1]) for b in batch])
            with torch.no_grad():
                logits = self.model(imgs.to(self.device), train=False).float().cpu().numpy()
            if confidences is None:
                confidences = {i: [] for i in range(logits.shape[-1])}
            pred = logits.argmax(-1)
            conf = logits.max(-1)
            for j in range(len(batch)):
                if pred[j] != tgts[j]:
                    continue  # wrongly classified images are not used
                confidences[int(tgts[j])].append((start + j, float(conf[j])))
        if confidences is None:
            confidences = {}
        for k in confidences:
            confidences[k].sort(key=lambda t: t[1], reverse=True)
        self.save_folder.mkdir(parents=True, exist_ok=True)
        with fp.open("wb") as f:
            pickle.dump(confidences, f)
        return confidences

    def get_sorted_indices(self, confidences) -> List[int]:
        """Blocks of n_imgs distinct confident classes, each class's images
        in decreasing confidence across blocks: the legacy MT19937 seeded
        with 42, classes in ascending id order and the strict
        ``mask.sum() > n_imgs`` stopping rule, draw for draw as the JAX
        package samples them."""
        rng = np.random.RandomState(self.config.get("seed", 42))
        n = self.config["n_imgs"]
        thresh = self.config["conf_thresh"]
        classes = np.array(sorted(int(k) for k in confidences))
        pos = {c: i for i, c in enumerate(classes)}
        pointers = {c: 0 for c in classes}
        idcs: List[int] = []

        def conf_ok(c: int) -> bool:
            v = confidences[c][pointers[c]][1]
            return thresh is None or 1.0 / (1.0 + math.exp(-v)) > thresh

        mask = np.array(
            [len(confidences[c]) > 0 and conf_ok(c) for c in classes], dtype=bool
        )
        while mask.sum() > n:
            sample = rng.choice(classes[mask], size=n, replace=False)
            for c in sample:
                c = int(c)
                idcs.append(confidences[c][pointers[c]][0])
                pointers[c] += 1
                mask[pos[c]] = (
                    conf_ok(c) if pointers[c] < len(confidences[c]) else False
                )
            if self.config["max_imgs"] and len(idcs) >= self.config["max_imgs"] * n:
                break
        return idcs

    def _score(self, attributions: np.ndarray, tgt_count: int, single_shape: int):
        """attributions [T, sH, sW] (channel-summed, clamped) -> each target's
        fraction of positive attribution inside its own cell."""
        T, H, W = attributions.shape
        s = H // single_shape
        cells = attributions.reshape(T, s, single_shape, s, single_shape).sum((2, 4))
        # cell (row=i%s, col=i//s) belongs to target i: column-major flatten
        flat = cells.transpose(0, 2, 1).reshape(T, -1)
        total = flat.sum(1, keepdims=True)
        frac = np.where(total * flat > 0, flat / np.maximum(total, 1e-12), 0.0)
        return np.asarray([frac[i, i] for i in range(T)])

    def _strided_attributions(self, explainer, multi_img: np.ndarray, tgts,
                              single_shape: int, stride: int) -> torch.Tensor:
        """The striding mode: the multi-image zero-padded by single_shape -
        stride on every side and cut into overlapping single_shape crops,
        each attributed for all targets, the channel sums added back where
        the crops overlap (in float64), the padding cut away: [T, sH, sW]."""
        ks = single_shape
        pad = ks - stride
        img = torch.as_tensor(np.asarray(multi_img)[0]).to(self.device)
        h, w, c = img.shape
        padded = torch.zeros((h + 2 * pad, w + 2 * pad, c), device=self.device)
        padded[pad:pad + h, pad:pad + w] = img
        acc = torch.zeros((len(tgts), h + 2 * pad, w + 2 * pad), dtype=torch.float64,
                          device=self.device)
        for i in range(0, h + 2 * pad - ks + 1, stride):
            for j in range(0, w + 2 * pad - ks + 1, stride):
                a = explainer.attribute_selection(padded[None, i:i + ks, j:j + ks], tgts)
                acc[:, i:i + ks, j:j + ks] += a.float().sum(-1)
        return acc[:, pad:pad + h, pad:pad + w].float()

    def analysis(self) -> Dict[str, np.ndarray]:
        confidences = self.compute_sorted_confs()
        fixed_indices = self.get_sorted_indices(confidences)
        n_imgs = self.config["n_imgs"]
        sample_size = self.config["sample_size"]
        explainer = get_explainer(
            self.model, self.config["explainer_name"], device=self.device,
            **self.config.get("explainer_kwargs", {}),
        )
        smooth = self.config["smooth"]

        single_shape = np.asarray(self.dataset[0][0]).shape[0]
        metric: List[np.ndarray] = []
        offset = 0
        count = 0
        while count < sample_size and offset + n_imgs <= len(fixed_indices):
            multi_img, tgts, offset = make_multi_image(
                n_imgs, self.dataset, offset=offset, fixed_indices=fixed_indices
            )
            striding = str(self.config.get("striding", "none"))
            if striding != "none":
                atts = self._strided_attributions(
                    explainer, multi_img, tgts, single_shape, int(striding)
                )
            else:
                atts = explainer.attribute_selection(multi_img, tgts).float().sum(-1)
            if smooth:
                atts = avg_pool2d(atts[..., None], smooth, 1, (smooth - 1) // 2)[..., 0]
            if self.config["neg"]:
                atts = -atts
            atts = atts.clamp_min(0).cpu().numpy()
            metric.append(self._score(atts, len(tgts), single_shape))
            count += 1

        result = np.concatenate(metric) if metric else np.zeros(0)
        if self.config["neg"]:
            result = 1 - result
        if not len(result):
            print(
                "Localisation metric is EMPTY: no grids of "
                f"{self.config['n_imgs']} distinct confidently-CORRECTLY-"
                "classified classes could be built (wrongly classified images "
                "are excluded). An untrained/early-epoch model typically "
                "classifies nothing correctly."
            )
        if len(result):
            print(
                f"Mean localisation metric: {result.mean():.4f} "
                f"(n={len(result)}); percentiles (25,50,75,100): "
                f"{np.percentile(result, [25, 50, 75, 100])}"
            )
        return {"localisation_metric": result}


def make_datamodule_for_config(experiment, cfg):
    """The evaluation data module of an analysis config; rescale mode shrinks
    the eval transform by the grid size, so that the n x n multi-image has
    the model's input size. Shared by the CLI and the sweep."""
    dm_overrides = {}
    if cfg.get("do_rescale"):
        prev = experiment.config["data"]["test_transform"]
        prev_args = getattr(prev, "args", {})
        if "crop_size" not in prev_args:
            raise ValueError(
                "rescale mode needs a resize/crop test transform preset "
                "(no crop_size on the experiment's test_transform)"
            )
        n = int(cfg["n_imgs"] ** 0.5)
        dm_overrides["test_transform"] = prev.with_args(
            crop_size=prev_args["crop_size"] // n,
            resize_size=prev_args.get("resize_size", 256) // n,
        )
    return experiment.get_datamodule(**dm_overrides)


def argument_parser(add_help: bool = True):
    """The JAX package's flags, the (dataset, base_network,
    experiment_name) triple beside --save_path."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Localisation analysis (grid pointing game).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        add_help=add_help,
    )
    parser.add_argument("--save_path", default=None,
                        help="Experiment save dir (alternative to the triple).")
    parser.add_argument("--dataset", default="ImageNet")
    parser.add_argument("--base_network", default="bcosification")
    parser.add_argument("--experiment_name", default=None)
    parser.add_argument("--reload", default="last",
                        help="last | best | best_any | epoch_<N>")
    parser.add_argument("--ema", action="store_true", default=False)
    parser.add_argument("--explainer_name", default="Ours")
    parser.add_argument("--analysis_config", default="500_3x3")
    parser.add_argument("--striding", default=None,
                        help="bare stride integer, e.g. 4, or 'none' "
                             "(default: whatever the analysis_config "
                             "encodes, e.g. '..._stride=14')")
    parser.add_argument("--explainer_config", default="default",
                        help="explainer kwarg preset name from "
                             "explanation_configs ('default' keeps the "
                             "explainer's own preset)")
    parser.add_argument("--batch_size", default=64, type=int)
    parser.add_argument("--smooth", required=True, type=int,
                        help="attribution smoothing (avg_pool) kernel")
    parser.add_argument("--force_confidence_calculation", action="store_true",
                        default=False)
    parser.add_argument("--save_root", default="localisation_results")
    parser.add_argument("--debug", action="store_true", default=False)
    return parser


def main(config=None, device=None):
    """The localisation command on ``device`` (default the GPU; "cpu" when
    asked): the trained model of the experiment, the analysis config's data
    module, the analyser's run, its results saved under --save_root."""
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
    from bcosification_tpu_torch.interpretability.analyses.localisation_configs import (
        configs as loc_configs,
    )
    from bcosification_tpu_torch.interpretability.explanation_methods import (
        explanation_configs,
    )

    dev = resolve_device(device)
    if config is None:
        config = argument_parser().parse_args()
    print("Starting localisation analysis for", config)

    if config.save_path:
        experiment = Experiment(path=config.save_path)
    else:
        assert config.experiment_name, "--experiment_name or --save_path required"
        experiment = Experiment(config.dataset, config.base_network, config.experiment_name)
    model = experiment.load_trained_model(config.reload, ema=config.ema, device=dev)

    cfg = dict(loc_configs[config.analysis_config])
    cfg.update(
        explainer_name=config.explainer_name,
        smooth=config.smooth,
        batch_size=config.batch_size,
    )
    if config.striding is not None:  # else: keep the config's encoded value
        cfg["striding"] = config.striding
    if config.explainer_config != "default":
        if config.explainer_config not in explanation_configs:
            raise ValueError(
                f"unknown --explainer_config {config.explainer_config!r}; "
                f"available: {sorted(explanation_configs)}"
            )
        cfg["explainer_kwargs"] = explanation_configs[config.explainer_config]
    dm = make_datamodule_for_config(experiment, cfg)
    dm.setup("test")
    save = os.path.join(
        config.save_root,
        config.experiment_name or os.path.basename(str(config.save_path)),
        config.analysis_config,
        config.explainer_name,
    )
    analyser = LocalisationAnalyser(model, dm.eval_dataset, save_folder=save, device=dev,
                                    **cfg)
    if config.force_confidence_calculation:
        fp = analyser.save_folder / "confidences.pkl"
        if fp.exists():
            fp.unlink()
    results = analyser.run()
    analyser.save_results(results, save)
    return results


if __name__ == "__main__":
    main()

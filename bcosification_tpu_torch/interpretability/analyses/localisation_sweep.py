"""Sweep the localisation analysis over explainers x configs (counterpart of
``bcosification_tpu/interpretability/analyses/localisation_sweep.py``).

    python -m bcosification_tpu_torch.interpretability.analyses.localisation_sweep \\
        --experiment_name resnet_50 --explainers Ours IxG --analysis_configs 250_3x3

The runs go one after the other on one GPU; RANK and WORLD_SIZE split them
across processes (run r takes every WORLD_SIZE-th run from RANK).
"""
import argparse
import os


def argument_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="ImageNet")
    parser.add_argument("--base_network", default="bcosification")
    parser.add_argument("--experiment_name", required=True)
    parser.add_argument("--reload", default="best_any")
    parser.add_argument(
        "--explainers", nargs="+",
        default=["Ours", "IxG", "Grad", "IntGrad"],
    )
    parser.add_argument("--analysis_configs", nargs="+", default=["250_3x3"])
    parser.add_argument("--save_root", default="localisation_results")
    return parser


def main(config=None, device=None):
    """The sweep of ``config`` (parsed from the command line when None) on
    ``device`` (default the GPU; "cpu" when asked)."""
    from bcosification_tpu_torch.device import resolve_device
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
    from bcosification_tpu_torch.interpretability.analyses.localisation import (
        LocalisationAnalyser,
        make_datamodule_for_config,
    )
    from bcosification_tpu_torch.interpretability.analyses.localisation_configs import (
        configs as loc_configs,
    )

    dev = resolve_device(device)
    args = argument_parser().parse_args() if config is None else config
    experiment = Experiment(args.dataset, args.base_network, args.experiment_name)
    model = experiment.load_trained_model(args.reload, device=dev)

    runs = [(e, c) for e in args.explainers for c in args.analysis_configs]
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    for explainer, cfg_name in runs[rank::world]:
        cfg = loc_configs[cfg_name]
        try:
            dm = make_datamodule_for_config(experiment, cfg)
        except ValueError as e:  # rescale without a crop preset
            print(f"skip {cfg_name}: {e}")
            continue
        dm.setup("test")
        save = os.path.join(args.save_root, args.experiment_name, cfg_name, explainer)
        analyser = LocalisationAnalyser(
            model, dm.eval_dataset, save_folder=save, device=dev,
            explainer_name=explainer, **cfg,
        )
        results = analyser.run()
        analyser.save_results(results, save)


if __name__ == "__main__":
    main()

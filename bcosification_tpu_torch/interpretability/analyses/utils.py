"""Analyser base: ``run`` and ``save_results`` with a config.log holding the
git commit (a copy of ``bcosification_tpu/interpretability/analyses/utils.py``)."""
from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np

__all__ = ["Analyser", "get_git_commit"]


def get_git_commit() -> str:
    try:
        return (
            subprocess.check_output(
                ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL
            )
            .decode()
            .strip()
        )
    except Exception:
        return "unknown"


class Analyser:
    default_config: Dict[str, Any] = {}

    def __init__(self, **config):
        self.config = {**self.default_config, **config}

    def analysis(self) -> Dict[str, Any]:
        raise NotImplementedError

    def run(self) -> Dict[str, Any]:
        t0 = time.time()
        results = self.analysis()
        print(f"Analysis took {time.time() - t0:.1f}s")
        return results

    def save_results(self, results: Dict[str, Any], save_folder) -> None:
        save_folder = Path(save_folder)
        save_folder.mkdir(parents=True, exist_ok=True)
        for k, v in results.items():
            np.save(save_folder / f"{k}.np", np.asarray(v), allow_pickle=False)
        with open(save_folder / "config.log", "w") as f:
            json.dump(
                {
                    "config": {k: str(v) for k, v in self.config.items()},
                    "git_commit": get_git_commit(),
                    "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
                },
                f,
                indent=1,
            )

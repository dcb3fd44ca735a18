"""Experiment configurations, by dataset and base network
(``<dataset>/<base_network>/{experiment_parameters,model}.py``), and the
``Experiment`` handle of ``utils/``."""

"""From-scratch SimpleViTs on ImageNet, standard baselines and B-cos ViTs:
the recipe grid (``experiment_parameters.CONFIGS``) and the model factory
(``model.get_model``)."""

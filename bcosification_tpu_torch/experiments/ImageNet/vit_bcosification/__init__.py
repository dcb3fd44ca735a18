"""B-cosification of the hub's standard SimpleViTs on ImageNet: the recipe
grid (``experiment_parameters.CONFIGS``) and the model factory
(``model.get_model``)."""

"""B-cosification of torchvision ImageNet classifiers: the recipe grid
(``experiment_parameters.CONFIGS``) and the model factory (``model.get_model``)."""

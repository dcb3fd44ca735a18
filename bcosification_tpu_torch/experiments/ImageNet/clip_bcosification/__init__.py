"""B-cosification of the CLIP-RN50 image tower by SigLIP knowledge
distillation on ImageNet: the recipe grid (``experiment_parameters.CONFIGS``)
and the model factory (``model.get_model``)."""

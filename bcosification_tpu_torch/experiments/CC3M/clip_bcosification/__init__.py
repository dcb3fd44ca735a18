"""B-cosification of the CLIP-RN50 image tower by SigLIP knowledge
distillation on CC3M's tar shards: the recipe grid
(``experiment_parameters.CONFIGS``) and the model factory (``model.get_model``,
ImageNet/clip_bcosification's)."""

"""The localisation config grid (a copy of
``bcosification_tpu/interpretability/analyses/localisation_configs.py``).

Names encode ``{sample_size}_{n}x{n}[_rescale][_noconfthresh][-stride=S][-neg]``
over sample sizes (500, 250, 50), grids (2, 3), rescale on or off, the
confidence threshold 0.5 or 0 ("noconfthresh"), strides (none, 4, 14, 28,
56, 112) and the sign flip: 288 configs, smooth=15 in each.
"""
from __future__ import annotations

configs = {
    (
        f"{sample_size}_{n}x{n}{rescale_sfx}{conf_sfx}{stride_sfx}{neg_sfx}"
    ): dict(
        sample_size=sample_size,
        n_imgs=n * n,
        do_rescale=do_rescale,
        conf_thresh=conf_thresh,
        striding=striding,
        neg=neg,
        smooth=15,
    )
    for sample_size in (500, 250, 50)
    for n in (2, 3)
    for rescale_sfx, do_rescale in (("_rescale", True), ("", False))
    for conf_sfx, conf_thresh in (("_noconfthresh", 0.0), ("", 0.5))
    for stride_sfx, striding in (
        ("", "none"),
        *((f"-stride={s}", str(s)) for s in (4, 14, 28, 56, 112)),
    )
    for neg_sfx, neg in (("", False), ("-neg", True))
}

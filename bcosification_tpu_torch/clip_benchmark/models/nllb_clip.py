"""NLLB-CLIP language plumbing + loader.

Parity target: `CLIP_benchmark/clip_benchmark/models/
nllb_clip.py` and its use in the reference cli (cli.py:262-264): NLLB-CLIP
models load through open_clip, and the tokenizer's source language must be
set from the benchmark's --language code before encoding text.

The reference ships a ~250-entry dict whose tail is an identity map over the
full NLLB-200 code list; here only the genuinely aliased short codes are a
table and FLORES-200-style codes (``xxx_Scri``) pass through unchanged.
"""
from __future__ import annotations

__all__ = ["resolve_lang", "set_language", "load_nllb_clip"]

# benchmark short codes -> NLLB-200 (FLORES-200) codes (ref nllb_clip.py:8-50)
_ALIASES = {
    "en": "eng_Latn", "es": "spa_Latn", "it": "ita_Latn", "ko": "kor_Hang",
    "ru": "rus_Cyrl", "zh": "zho_Hant", "de": "deu_Latn", "fr": "fra_Latn",
    "jp": "jpn_Jpan", "cn": "zho_Hant", "zhm": "yue_Hant", "ar": "arb_Arab",
    "bn": "ben_Beng", "cs": "ces_Latn", "da": "dan_Latn", "el": "ell_Grek",
    "fa": "pes_Arab", "fi": "fin_Latn", "fil": "tgl_Latn", "hi": "hin_Deva",
    "hr": "hrv_Latn", "hu": "hun_Latn", "ja": "jpn_Jpan", "id": "ind_Latn",
    "he": "heb_Hebr", "mi": "mri_Latn", "nl": "nld_Latn", "no": "nno_Latn",
    "pl": "pol_Latn", "pt": "por_Latn", "quz": "quy_Latn", "ro": "ron_Latn",
    "sv": "swe_Latn", "sw": "swh_Latn", "te": "tel_Telu", "th": "tha_Thai",
    "tr": "tur_Latn", "uk": "ukr_Cyrl", "vi": "vie_Latn", "mk": "mkd_Cyrl",
}


def resolve_lang(lang_code: str) -> str:
    """Short benchmark code or FLORES code -> NLLB-200 code."""
    if lang_code in _ALIASES:
        return _ALIASES[lang_code]
    if "_" in lang_code:  # already a FLORES-200 code (identity in the ref map)
        return lang_code
    raise KeyError(
        f"unknown language code {lang_code!r} for NLLB-CLIP (expected a "
        "benchmark short code or a FLORES-200 code like 'eng_Latn')"
    )


def set_language(tokenizer, lang_code: str) -> None:
    """Point the (HF-backed) open_clip tokenizer at the source language
    (ref nllb_clip.py::set_language)."""
    lang = resolve_lang(lang_code)
    print(f"Setting language for NLLB-CLIP: {lang}")
    tokenizer.tokenizer.set_src_lang_special_tokens(lang)


def load_nllb_clip(model_name: str, pretrained: str = "", device: str = "cpu",
                   cache_dir=None, **kwargs):
    """NLLB-CLIP rides open_clip (the reference has no separate loader;
    cli.py:262 routes nllb-clip model names through open_clip + set_language)."""
    from bcosification_tpu_torch.clip_benchmark.models.open_clip import load_open_clip

    return load_open_clip(
        model_name=model_name, pretrained=pretrained, device=device,
        cache_dir=cache_dir, **kwargs,
    )

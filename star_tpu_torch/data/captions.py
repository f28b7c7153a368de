"""Caption cleaning for the text-conditioning data path (counterpart of
star_tpu/data/captions.py; host strings, the same passes in the same
order). bs4 is imported only when a caption is cleaned.

Behavioral reference: video_to_video/modules/t5.py:199-335 (`basic_clean`,
`clean_caption`, `text_preprocessing` — the DeepFloyd-style cleaner the
reference applies to training captions; the webdataset loaders in
cogvideox-based/sat/data_video.py route captions through the same kind of
hook). Host-side pure-string work, so the port is behavioral: same pass
order, same regex semantics.

Dependency notes for this image: bs4 is available (used for HTML stripping
like the reference); ftfy is NOT — mojibake fixing degrades to plain
unicode normalization + html.unescape, which covers the escape-entity part
of ftfy.fix_text that the caption distribution actually exercises.
"""

from __future__ import annotations

import html
import re
import unicodedata
import urllib.parse as ul

_BAD_PUNCT = re.compile(
    r'[#®•©™&@·º½¾¿¡§~\)\(\]\[\}\{\|\\/\*]{1,}')

_URL1 = re.compile(
    r'\b((?:https?:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.]'
    r'(?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))')
_URL2 = re.compile(
    r'\b((?:www:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.]'
    r'(?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))')

# CJK blocks stripped by the reference (t5.py:236-250)
_CJK = [re.compile(rf'[{a}-{b}]+') for a, b in [
    ('\u31c0', '\u31ef'), ('\u31f0', '\u31ff'), ('\u3200', '\u32ff'),
    ('\u3300', '\u33ff'), ('\u3400', '\u4dbf'), ('\u4dc0', '\u4dff'),
    ('\u4e00', '\u9fff')]]

_DASHES = re.compile(
    '[\u002D\u058A\u05BE\u1400\u1806\u2010-\u2015\u2E17\u2E1A\u2E3A'
    '\u2E3B\u2E40\u301C\u3030\u30A0\uFE31\uFE32\uFE58\uFE63\uFF0D]+')
_HYPHEN_UNDERSCORE = re.compile(r'(?:\-|\_)')


def basic_clean(text: str) -> str:
    """t5.py:199-202 minus ftfy (unavailable here): NFC-normalize + double
    html.unescape + strip."""
    text = unicodedata.normalize('NFC', text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def clean_caption(caption: str) -> str:
    """One cleaning pass (t5.py:210-327). Order matters and is preserved."""
    from bs4 import BeautifulSoup

    caption = str(caption)
    caption = ul.unquote_plus(caption)
    caption = caption.strip().lower()
    caption = re.sub('<person>', 'person', caption)
    caption = _URL1.sub('', caption)
    caption = _URL2.sub('', caption)
    caption = BeautifulSoup(caption, features='html.parser').text
    caption = re.sub(r'@[\w\d]+\b', '', caption)          # @nickname
    for pat in _CJK:
        caption = pat.sub('', caption)
    caption = _DASHES.sub('-', caption)
    caption = re.sub(r'[`´«»“”¨]', '"', caption)
    caption = re.sub(r'[‘’]', "'", caption)
    caption = re.sub(r'&quot;?', '', caption)
    caption = re.sub(r'&amp', '', caption)
    caption = re.sub(r'\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}', ' ', caption)
    caption = re.sub(r'\d:\d\d\s+$', '', caption)         # article ids
    caption = re.sub(r'\\n', ' ', caption)
    caption = re.sub(r'#\d{1,3}\b', '', caption)
    caption = re.sub(r'#\d{5,}\b', '', caption)
    caption = re.sub(r'\b\d{6,}\b', '', caption)
    caption = re.sub(
        r'[\S]+\.(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)', '', caption)
    caption = re.sub(r'[\"\']{2,}', r'"', caption)
    caption = re.sub(r'[\.]{2,}', r' ', caption)
    caption = _BAD_PUNCT.sub(r' ', caption)
    caption = re.sub(r'\s+\.\s+', r' ', caption)
    if len(_HYPHEN_UNDERSCORE.findall(caption)) > 3:
        caption = _HYPHEN_UNDERSCORE.sub(' ', caption)
    caption = basic_clean(caption)
    caption = re.sub(r'\b[a-zA-Z]{1,3}\d{3,15}\b', '', caption)   # jc6640
    caption = re.sub(r'\b[a-zA-Z]+\d+[a-zA-Z]+\b', '', caption)   # jc6640vc
    caption = re.sub(r'\b\d+[a-zA-Z]+\d+\b', '', caption)         # 6640vc231
    caption = re.sub(r'(worldwide\s+)?(free\s+)?shipping', '', caption)
    caption = re.sub(r'(free\s)?download(\sfree)?', '', caption)
    caption = re.sub(r'\bclick\b\s(?:for|on)\s\w+', '', caption)
    caption = re.sub(
        r'\b(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)(\simage[s]?)?', '',
        caption)
    caption = re.sub(r'\bpage\s+\d+\b', '', caption)
    caption = re.sub(r'\b\d*[a-zA-Z]+\d+[a-zA-Z]+\d+[a-zA-Z\d]*\b', r' ',
                     caption)                                     # j2d1a2a
    caption = re.sub(r'\b\d+\.?\d*[xх×]\d+\.?\d*\b', '', caption)
    caption = re.sub(r'\b\s+\:\s+', r': ', caption)
    caption = re.sub(r'(\D[,\./])\b', r'\1 ', caption)
    caption = re.sub(r'\s+', ' ', caption)
    caption = re.sub(r'^[\"\']([\w\W]+)[\"\']$', r'\1', caption)
    caption = re.sub(r"^[\'\_,\-\:;]", r'', caption)
    caption = re.sub(r"[\'\_,\-\:\-\+]$", r'', caption)
    caption = re.sub(r'^\.\S+$', '', caption)
    return caption.strip()


def text_preprocessing(text: str, use_text_preprocessing: bool = True) -> str:
    """t5.py:330-335: the training-stage cleaner runs clean_caption TWICE."""
    if use_text_preprocessing:
        return clean_caption(clean_caption(text))
    return text.lower().strip()

"""Chinese text normalization (clean-room).

Behavioral equivalent of the reference normalizer
(``G2P/Chinese/Normalization/{text_normlization,num,chronology,quantifier,
phonecode}.py``) with an independent implementation: dates (both 年月日 and
ISO styles), clock times (incl. 半 and ranges), temperatures, measure-unit
words, arithmetic operators, superscript powers, fractions, percentages,
phone numbers (幺 digit reading), numeric ranges, version numbers,
quantifier-aware cardinals (二→两), code-number digit reading, decimals,
circled digits, greek letters, and the special-character filters.

The replacement ORDER matches the reference pipeline
(text_normlization.py:110-149) because the rules overlap (e.g. times must be
consumed before bare-number rules see the digits).
"""
from __future__ import annotations

import re

DIGITS = "零一二三四五六七八九"
UNITS = ["", "十", "百", "千"]
GROUP_UNITS = ["", "万", "亿", "万亿"]


# ---------------------------------------------------------------------------
# number verbalization
# ---------------------------------------------------------------------------

def num_to_zh(num_str: str) -> str:
    """Cardinal integer → Chinese reading."""
    num_str = num_str.lstrip("0") or "0"
    if num_str == "0":
        return "零"
    groups = []
    s = num_str
    while s:
        groups.append(s[-4:])
        s = s[:-4]
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi].rjust(4, "0")
        piece = ""
        zero_pending = False
        for i, ch in enumerate(g):
            d = int(ch)
            unit = UNITS[3 - i]
            if d == 0:
                if piece:
                    zero_pending = True
            else:
                if zero_pending:
                    piece += "零"
                    zero_pending = False
                piece += DIGITS[d] + unit
        if piece:
            # a leading zero inside this group needs 零 after the higher group
            if parts and g[0] == "0":
                piece = "零" + piece
            piece += GROUP_UNITS[gi]
            parts.append(piece)
        elif parts and gi > 0 and any(int(c) for grp in groups[:gi] for c in grp):
            # inner all-zero group introduces a 零 if more digits follow
            parts.append("零")
    out = "".join(parts)
    out = re.sub("零+", "零", out).rstrip("零") or "零"
    # 一十X → 十X at the very front (10-19)
    if out.startswith("一十"):
        out = out[2:] and "十" + out[2:] or "十"
    return out


def digits_to_zh(num_str: str, phone: bool = False) -> str:
    """Digit-by-digit reading; ``phone=True`` reads 1 as 幺 (alt_one)."""
    out = "".join(DIGITS[int(c)] for c in num_str if c.isdigit())
    return out.replace("一", "幺") if phone else out


def decimal_to_zh(s: str) -> str:
    """num2str semantics (num.py:317-339): trailing zeros in the fraction
    collapse to a single 零 ('3.200' → 三点二零, '3.00' → 三点零)."""
    neg = s.startswith("-")
    s = s.lstrip("+-")
    if "." in s:
        a, b = s.split(".", 1)
        if b.endswith("0"):
            b = b.rstrip("0") + "0"
        out = num_to_zh(a) if a else ""
        if b:
            out = (out or "零") + "点" + digits_to_zh(b)
        elif not out:
            out = "零"
    else:
        out = num_to_zh(s)
    return ("负" if neg else "") + out


# ---------------------------------------------------------------------------
# patterns (ordered per the reference pipeline)
# ---------------------------------------------------------------------------

_RE_DATE_CN = re.compile(
    r"(\d{4}|\d{2})年(?:(0?[1-9]|1[0-2])月)?(?:(0?[1-9]|[12][0-9]|3[01])([日号]))?")
_RE_DATE_ISO = re.compile(r"(\d{4})([-/. ])(0[1-9]|1[012])\2(0[1-9]|[12][0-9]|3[01])")
_TIME_PART = r"([01]?[0-9]|2[0-3]):([0-5][0-9])(?::([0-5][0-9]))?"
_RE_TIME_RANGE = re.compile(_TIME_PART + r"[~-]" + _TIME_PART)
_RE_TIME = re.compile(_TIME_PART)

_UNIT_WORDS = [
    ("cm²", "平方厘米"), ("cm2", "平方厘米"), ("cm³", "立方厘米"),
    ("cm3", "立方厘米"), ("cm", "厘米"), ("db", "分贝"), ("ds", "毫秒"),
    ("kg", "千克"), ("km", "千米"), ("m²", "平方米"), ("m2", "平方米"),
    ("m³", "立方米"), ("m3", "立方米"), ("ml", "毫升"),
    # the reference's measure_dict iterates "m" BEFORE "mm"
    # (quantifier.py:21-38), so "5mm" reads 五米米 — quirk reproduced
    ("m", "米"), ("mm", "毫米"), ("s", "秒"),
]
_UNIT_ALT = "|".join(re.escape(u) for u, _ in _UNIT_WORDS) + "|%|°C|℃|度|摄氏度"
_NUM_PART = r"-?(?:\d+(?:\.\d+)?|\.\d+)"
_RE_UNIT_RANGE = re.compile(
    f"({_NUM_PART})({_UNIT_ALT})~({_NUM_PART})({_UNIT_ALT})")
_RE_TEMP = re.compile(r"(-?)(\d+(?:\.\d+)?)(°C|℃|度|摄氏度)")

_SUPERSCRIPTS = "⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ"
_SUP_TO_CHAR = dict(zip(_SUPERSCRIPTS, "0123456789xyn"))
_ASMD_OPERAND = (r"(?:-?(?:\d+(?:\.\d+)?|\.\d+)[" + _SUPERSCRIPTS + r"]*"
                 r"|[A-Za-z][" + _SUPERSCRIPTS + r"]*)")
_RE_ASMD = re.compile(f"({_ASMD_OPERAND})([+\\-×÷=])({_ASMD_OPERAND})")
_ASMD_MAP = {"+": "加", "-": "减", "×": "乘", "÷": "除", "=": "等于"}
_RE_POWER = re.compile("[" + _SUPERSCRIPTS + "]+")

_RE_FRACTION = re.compile(r"(-?)(\d+)/(\d+)")
_RE_PERCENT = re.compile(r"(-?)(\d+(?:\.\d+)?)%")
_RE_MOBILE = re.compile(r"(?<!\d)(\+?86 ?)?1(?:[38]\d|5[0-35-9]|7[678]|9[89])\d{8}(?!\d)")
_RE_LANDLINE = re.compile(r"(?<!\d)(?:0(?:10|2[1-3]|[3-9]\d{2})-?)?[1-9]\d{6,7}(?!\d)")
_RE_HOTLINE = re.compile(r"400-?\d{3}-?\d{4}")
_RE_RANGE = re.compile(
    r"(?<![\d+\-×÷=])(-?\d+(?:\.\d+)?)[-~](-?\d+(?:\.\d+)?)(?![\d+\-×÷=])")
_RE_NEG_INT = re.compile(r"-(\d+)")
_RE_VERSION = re.compile(r"\d+(?:\.\d+){2,}")
_RE_DECIMAL = re.compile(r"(-?)(?:(\d+)(\.\d+)|\.(\d+))")

# cardinal+quantifier rule (num.py:171-191): the quantifier set is the
# reference's COM_QUANTIFIERS regex ALTERNATION (num.py:34) — branch ORDER
# and group structure are behavior ("2万人" reads 两万人 because bare scale
# words are branches; bare 克 is NOT — only (千|毫|微)克; "2次" stays 二次).
# Constant linguistic data where exact behavior is the contract, kept as
# the same branch sequence; the test suite pins it against the reference
# string (test_frontend: COM_QUANTIFIERS parity).
_QUANT_BRANCHES = (
    "处 台 架 枚 趟 幅 平 方 堵 间 床 株 批 项 例 列 篇 栋 注 亩 封 艘 把 "
    "目 套 段 人 所 朵 匹 张 座 回 场 尾 条 个 首 阙 阵 网 炮 顶 丘 棵 只 "
    "支 袭 辆 挑 担 颗 壳 窠 曲 墙 群 腔 砣 座 客 贯 扎 捆 刀 令 打 手 罗 "
    "坡 山 岭 江 溪 钟 队 单 双 对 出 口 头 脚 板 跳 枝 件 贴 针 线 管 名 "
    "位 身 堂 课 本 页 家 户 层 丝 毫 厘 分 钱 两 斤 担 铢 石 钧 锱 忽"
).split() + [
    "(千|毫|微)克", "毫", "厘", "(公)分", "分", "寸", "尺", "丈", "里",
    "寻", "常", "铺", "程", "(千|分|厘|毫|微)米", "米", "撮", "勺", "合",
    "升", "斗", "石", "盘", "碗", "碟", "叠", "桶", "笼", "盆", "盒", "杯",
    "钟", "斛", "锅", "簋", "篮", "盘", "桶", "罐", "瓶", "壶", "卮", "盏",
    "箩", "箱", "煲", "啖", "袋", "钵", "年", "月", "日", "季", "刻", "时",
    "周", "天", "秒", "分", "小时", "旬", "纪", "岁", "世", "更", "夜",
    "春", "夏", "秋", "冬", "代", "伏", "辈", "丸", "泡", "粒", "颗", "幢",
    "堆", "条", "根", "支", "道", "面", "片", "张", "颗", "块", "元",
    "(亿|千万|百万|万|千|百)", "(亿|千万|百万|万|千|百|美|)元",
    "(亿|千万|百万|万|千|百|十|)吨", "(亿|千万|百万|万|千|百|)块",
    "角", "毛", "分",
]
_RE_QUANTIFIER = re.compile(
    r"(\d+)([多余几+])?(" + "|".join(_QUANT_BRANCHES) + ")")
_RE_CODE_NUM = re.compile(r"\d{3}\d*")
_RE_NUMBER = re.compile(r"(-?)(\d+(?:\.\d+)?|\.\d+)")

# full-width → half-width for LETTERS, DIGITS and the ideographic space
# ONLY (constants.py:21-37 + text_normlization.py:112): full-width
# punctuation like ％/～ stays full-width, so the %/~ number rules never
# see it — "50％的人" keeps its ％ (later stripped), matching the oracle
_F2H = str.maketrans(
    {chr(0xFF10 + i): chr(0x30 + i) for i in range(10)} |
    {chr(0xFF21 + i): chr(0x41 + i) for i in range(26)} |
    {chr(0xFF41 + i): chr(0x61 + i) for i in range(26)} | {"　": " "})
_CIRCLED = str.maketrans("①②③④⑤⑥⑦⑧⑨⑩", "一二三四五六七八九十")
_GREEK = [
    ("α", "阿尔法"), ("β", "贝塔"), ("γ", "伽玛"), ("Γ", "伽玛"),
    ("δ", "德尔塔"), ("Δ", "德尔塔"), ("ε", "艾普西龙"), ("ζ", "捷塔"),
    ("η", "依塔"), ("θ", "西塔"), ("Θ", "西塔"), ("ι", "艾欧塔"),
    ("κ", "喀帕"), ("λ", "拉姆达"), ("Λ", "拉姆达"), ("μ", "缪"),
    ("ν", "拗"), ("ξ", "克西"), ("Ξ", "克西"), ("ο", "欧米克伦"),
    ("π", "派"), ("Π", "派"), ("ρ", "肉"), ("ς", "西格玛"), ("Σ", "西格玛"),
    ("σ", "西格玛"), ("τ", "套"), ("υ", "宇普西龙"), ("φ", "服艾"),
    ("Φ", "服艾"), ("χ", "器"), ("ψ", "普赛"), ("Ψ", "普赛"),
    ("ω", "欧米伽"), ("Ω", "欧米伽"),
]
_PRE_FILTER = re.compile(r"[——《》【】<>{}()（）#&@“”^_|\\]")
_POST_FILTER = re.compile(r"[-——《》【】<=>{}()（）#&@“”^_|\\]")


def _rep_date_cn(m: re.Match) -> str:
    y, mo, d, suffix = m.groups()
    out = digits_to_zh(y) + "年"
    if mo:
        out += num_to_zh(mo) + "月"
    if d:
        out += num_to_zh(d) + suffix
    return out


def _rep_date_iso(m: re.Match) -> str:
    y, _, mo, d = m.groups()
    return f"{digits_to_zh(y)}年{num_to_zh(mo)}月{num_to_zh(d)}日"


def _speak_minute(minute: str) -> str:
    # leading-zero minutes keep the 零: 8:05 → 八点零五分
    out = num_to_zh(minute.lstrip("0"))
    if minute.startswith("0"):
        out = "零" + out
    return out


def _speak_clock(h: str, mi: str, sec: str, half_on: str) -> str:
    out = num_to_zh(h) + "点"
    if mi.lstrip("0"):
        # NOTE: for ranges the reference checks the FIRST minute for 半 on
        # both ends (chronology.py:77-84); reproduced for parity.
        out += "半" if int(half_on) == 30 else _speak_minute(mi) + "分"
    if sec and sec.lstrip("0"):
        out += _speak_minute(sec) + "秒"
    return out


def _rep_time(m: re.Match) -> str:
    g = m.groups()
    out = _speak_clock(g[0], g[1], g[2], g[1])
    if len(g) > 3:
        out += "至" + _speak_clock(g[3], g[4], g[5], g[1])
    return out


def _rep_phone(s: str) -> str:
    parts = s.lstrip("+").replace(" ", "-").split("-")
    return "，".join(digits_to_zh(p, phone=True) for p in parts if p)


def _rep_quantifier(m: re.Match) -> str:
    number = num_to_zh(m.group(1))
    if number == "二":
        number = "两"
    approx = {"+": "多"}.get(m.group(2), m.group(2) or "")
    return number + approx + m.group(3)


def normalize(text: str) -> str:
    # full-width → half-width; zh text drops spaces and decorative characters
    # (text_normlization.py:51-60,112)
    text = text.translate(_F2H).replace(" ", "")
    text = _PRE_FILTER.sub("", text)

    text = _RE_DATE_CN.sub(_rep_date_cn, text)
    text = _RE_DATE_ISO.sub(_rep_date_iso, text)
    text = _RE_TIME_RANGE.sub(_rep_time, text)
    text = _RE_TIME.sub(_rep_time, text)
    text = _RE_UNIT_RANGE.sub(lambda m: m.group(0).replace("~", "至"), text)
    # NOTE: the reference reads the unit from the decimal subgroup
    # (quantifier.py:51 group(3) is "(\.\d+)"), so every temperature comes
    # out as 度 regardless of how the unit was written; reproduced for parity.
    text = _RE_TEMP.sub(lambda m: ("零下" if m.group(1) else "")
                        + decimal_to_zh(m.group(2)) + "度", text)
    for unit, word in _UNIT_WORDS:
        if unit in text:
            text = text.replace(unit, word)
    while _RE_ASMD.search(text):
        text = _RE_ASMD.sub(
            lambda m: m.group(1) + _ASMD_MAP[m.group(2)] + m.group(3), text)
    text = _RE_POWER.sub(
        lambda m: "的" + "".join(_SUP_TO_CHAR[c] for c in m.group(0)) + "次方",
        text)
    text = _RE_FRACTION.sub(
        lambda m: ("负" if m.group(1) else "")
        + f"{num_to_zh(m.group(3))}分之{num_to_zh(m.group(2))}", text)
    text = _RE_PERCENT.sub(
        lambda m: ("负" if m.group(1) else "") + "百分之"
        + decimal_to_zh(m.group(2)), text)
    text = _RE_MOBILE.sub(lambda m: _rep_phone(m.group(0)), text)
    text = _RE_LANDLINE.sub(lambda m: _rep_phone(m.group(0)), text)
    text = _RE_HOTLINE.sub(lambda m: _rep_phone(m.group(0)), text)
    text = _RE_RANGE.sub(
        lambda m: f"{decimal_to_zh(m.group(1))}到{decimal_to_zh(m.group(2))}",
        text)
    text = _RE_NEG_INT.sub(lambda m: "负" + num_to_zh(m.group(1)), text)
    text = _RE_VERSION.sub(
        lambda m: "".join("点" if c == "." else DIGITS[int(c)]
                          for c in m.group(0)), text)
    text = _RE_DECIMAL.sub(lambda m: decimal_to_zh(m.group(0)), text)
    text = _RE_QUANTIFIER.sub(_rep_quantifier, text)
    text = _RE_CODE_NUM.sub(lambda m: digits_to_zh(m.group(0), phone=True),
                            text)
    text = _RE_NUMBER.sub(lambda m: decimal_to_zh(m.group(0)), text)

    # post replacements (text_normlization.py:62-108)
    text = text.replace("/", "每").translate(_CIRCLED)
    for greek, word in _GREEK:
        text = text.replace(greek, word)
    for op, word in [("+", "加"), ("-", "减"), ("×", "乘"), ("÷", "除"),
                     ("=", "等")]:
        text = text.replace(op, word)
    return _POST_FILTER.sub("", text)

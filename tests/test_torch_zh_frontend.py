"""The port's Chinese frontend: its own copies of ``chinese``, ``zh_norm``,
``tone_sandhi`` and ``assets/zh_sandhi.json`` behind its dispatcher give the
same phones, ``word2ph`` and normalized text as the JAX package's
``get_phones_and_bert``, on Chinese and mixed zh/en sentences (numbers and
dates, 一/不 sandhi, erhua).  ``pypinyin`` is absent here: both packages take
an injected lexicon-backed ``ChineseG2P``."""
import types

import pytest

from test_torch_assets import text_modules_as_installed  # noqa: F401

#: toned pinyin of every character the sentences below reach after normalization
ZH_LEXICON = {
    "你": "ni3", "好": "hao3", "不": "bu4", "是": "shi4", "一": "yi1", "个": "ge4",
    "中": "zhong1", "国": "guo2", "人": "ren2", "我": "wo3", "爱": "ai4", "天": "tian1",
    "气": "qi4", "很": "hen3", "雨": "yu3", "儿": "er2", "女": "nv3", "花": "hua1",
    "点": "dian3", "分": "fen1", "之": "zhi1", "百": "bai3", "十": "shi2", "二": "er4",
    "三": "san1", "四": "si4", "五": "wu3", "六": "liu4", "七": "qi1", "八": "ba1",
    "九": "jiu3", "零": "ling2", "年": "nian2", "月": "yue4", "日": "ri4", "负": "fu4",
    "度": "du4", "千": "qian1", "下": "xia4", "们": "men5", "看": "kan4", "世": "shi4",
    "界": "jie4", "今": "jin1", "温": "wen1", "价": "jia4", "格": "ge2", "这": "zhe4",
    "玩": "wan2", "去": "qu4", "吧": "ba5", "小": "xiao3", "院": "yuan4", "里": "li3",
    "有": "you3", "的": "de5", "它": "ta1", "用": "yong4", "说": "shuo1", "也": "ye3",
    "文": "wen2", "吗": "ma5",
}

SENTENCES = [
    "你好，世界。",
    "我不是中国人，我不爱下雨天。",
    "一个人看一看，一天一点。",
    "今天是2024年5月12日，气温是负3.5度。",
    "百分之五十的人很爱花儿，小院儿里有女儿。",
    "这个价格是12.5%，玩儿去吧！",
    "我爱 GPT-SoVITS，它很好用。",
    "Hello，你好 world，我们说 English 也说中文吗？",
]


@pytest.fixture
def zh_g2p_in_both():
    """A lexicon-backed ``ChineseG2P`` injected into each package's
    ``global_config``, restored afterwards."""
    from gsv_tts_tpu.config import global_config as jax_global
    from gsv_tts_tpu.frontend.g2p.chinese import ChineseG2P as JaxG2P
    from gsv_tts_tpu_torch.config import global_config as port_global
    from gsv_tts_tpu_torch.frontend.g2p.chinese import ChineseG2P as PortG2P

    saved = jax_global.chinese_g2p, port_global.chinese_g2p
    jax_global.chinese_g2p = JaxG2P(lexicon=ZH_LEXICON)
    port_global.chinese_g2p = PortG2P(lexicon=ZH_LEXICON)
    try:
        yield
    finally:
        jax_global.chinese_g2p, port_global.chinese_g2p = saved


@pytest.mark.parametrize("text", SENTENCES)
def test_chinese_phones_match_jax(text, zh_g2p_in_both):
    from gsv_tts_tpu.frontend.text_processor import get_phones_and_bert as jax_fe
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.frontend.text_processor import get_phones_and_bert as port_fe

    jp, jw, jb, jn = jax_fe(text, types.SimpleNamespace(models_dir=None, cnroberta=None))
    pp, pw, pb, pn = port_fe(text, Config(device="cpu"))
    assert pp == jp and pw == jw and pn == jn
    assert pb.shape == jb.shape == (len(pp), 1024) and not pb.any()
    assert len(pp) == sum(pw["ph"]) > 0


def test_sandhi_and_numbers_reach_the_phones(zh_g2p_in_both):
    """The rules the sentences are there for did run: 不 before a fourth tone
    and 一 before 个 turn second tone, 一 between reduplicated verbs neutral,
    and numbers are read out in Chinese."""
    from gsv_tts_tpu_torch.frontend.g2p import text_to_phonemes

    phones, _, _ = text_to_phonemes(SENTENCES[1], "zh")
    assert phones[2:4] == ["b", "u2"]  # 我不是: bu2 shi4
    phones, _, _ = text_to_phonemes(SENTENCES[2], "zh")
    assert phones[:2] == ["y", "i2"] and "i5" in phones  # 一个 yi2, 看一看 yi5
    _, _, norm = text_to_phonemes(SENTENCES[3], "zh")
    assert "二零二四年" in norm and "负三点五度" in norm


def test_dispatcher_builds_a_zh_engine_per_models_dir(tmp_path):
    """Without an injected engine the dispatcher builds one ``ChineseG2P``
    per models directory, reading its ``g2p/zh/pinyin.txt`` lexicon, and
    ``use_jieba_fast`` reaches it; an injected engine wins."""
    from gsv_tts_tpu_torch.config import global_config
    from gsv_tts_tpu_torch.frontend.g2p import _get_g2p, text_to_phonemes
    from gsv_tts_tpu_torch.frontend.g2p.chinese import ChineseG2P

    lex = tmp_path / "g2p" / "zh" / "pinyin.txt"
    lex.parent.mkdir(parents=True)
    lex.write_text("".join(f"{k}\t{v}\n" for k, v in ZH_LEXICON.items()), encoding="utf-8")
    saved = global_config.chinese_g2p
    global_config.chinese_g2p = None
    try:
        phones, word2ph, norm = text_to_phonemes("你好。", "zh", models_dir=tmp_path)
        assert phones == ["n", "i2", "h", "ao3", "."] and norm == "你好。"
        built = global_config.chinese_g2p
        assert built._auto_models_dir == str(tmp_path)
        assert _get_g2p("zh", tmp_path) is built
        injected = ChineseG2P(lexicon=ZH_LEXICON)
        global_config.chinese_g2p = injected
        assert _get_g2p("zh", tmp_path) is injected
    finally:
        global_config.chinese_g2p = saved

"""Chinese prompt handling: detection, Traditional -> Simplified, zh -> en.

Counterpart of `clip_diffusion_tpu.text.zh`, with its own copy of the
tables.  Chinese is detected by the CJK range [\\u4e00-\\u9FFF].
Traditional -> Simplified uses OpenCC "tw2sp" when it can be imported,
else a curated Taiwan-phrase table (overlaid by `OPENCC_TW2SP_TSV`, default
data/opencc/tw2sp_phrases.tsv, when that file exists) and a character
table.  Translation uses an injected translator, else the default one
(`default_translator`): the port's MarianMT when the zoo's `marian_zh_en`
slot and the tokenizer assets are provisioned.  Without one the prompt
passes through untranslated, with a warning.
"""

from __future__ import annotations

import functools
import os
import re
import warnings
from typing import Callable, Optional

_ZH_RE = re.compile(r"[一-鿿]")

# Compact Traditional -> Simplified character table (most frequent
# divergent characters; char-level fallback for the OpenCC tw2sp step).
_T2S = str.maketrans(
    "萬與醜專業叢東絲丟兩嚴喪個爿豐臨為麗舉麼義烏樂喬習鄉書買亂爭於虧雲亞產畝親褻嚲億僅從侖倉儀們價眾優會傴傘偉傳傷倀倫傯佇體餘傭僉俠侶僥偵側僑儈儕儂俁儔儼倆儷儉債傾傮僂剮劊別刪剄則剛創刪勸辦務勱動勵勁勞勢勳猛勩勻匭匱區醫華協單賣盧鹵臥衛卻巹廠廳歷厲壓厭厙參靉靆雙發變敘疊葉號嘆嘰籲後嚇呂嗎唚噸聽啟吳嘸囈嘔嚦唄員咼嗆嗚詠哢嚨嚀噝吒噅鹹呱響啞噠嘵嗶噦嘩噲嚌噥喲嘜嗊嘮啢嗩唕喚呼嘖嗇囀齧囉嘽嘯噴嘍嚳囁嗬噯噓嚶囑嚕劈囂謔團園囪圍圇國圖圓聖壙場阪壞塊堅壇壢壩塢墳墜壟壟壚壘墾坰堊墊埡墶壋塏堖塒塤堝墊垻壪壎堯報場"
    ,
    "万与丑专业丛东丝丢两严丧个丬丰临为丽举么义乌乐乔习乡书买乱争于亏云亚产亩亲亵亸亿仅从仑仓仪们价众优会伛伞伟传伤伥伦偬伫体余佣佥侠侣侥侦侧侨侩侪侬俣俦俨俩俪俭债倾倮偻剐刽别删刭则刚创刬劝办务劢动励劲劳势勋猛勚匀匦匮区医华协单卖卢卤卧卫却卺厂厅历厉压厌厍参叆叇双发变叙叠叶号叹叽吁后吓吕吗唚吨听启吴呒呓呕呖呗员呙呛呜咏咔咙咛咝咤咴咸呱响哑哒哓哔哕哗哙哜哝哟唛唝唠唡唢唣唤呼啧啬啭啮啰啴啸喷喽喾嗫嗬嗳嘘嘤嘱噜噼嚣谑团园囱围囵国图圆圣圹场坂坏块坚坛坜坝坞坟坠垄垄垆垒垦垧垩垫垭垯垱垲垴埘埙埚垫坝塆塇尧报场"
)

# supplementary frequent characters (image-prompt vocabulary: animals,
# scenery, art/media, tech) the compact table above misses
_T2S_EXTRA = str.maketrans(
    "師薩學機電腦鍵盤網貓愛隻風畫寫讀說話語詞譯試誰請謝門問間聞開關飛馬鳥魚龍龜鐵銀錢鋼錄鏡長車軟輕輪運過達遠選邊郵頁頭顏題飯飲館驚驗騎髮鮮鴨鷹麥黃點齒紅紙級細終結給統綠線練組經總織繪續羅聲職藝藍舊節藥蟲蘭蝦術視覺觀計訊記設證詩認調談論講識護讓貝負財貨質購趕較轉雞鵝貳雲島嶼嶺巖靈顯騰鳴麗攝錶燈燭爍爛獅猿獸環瑪璃瓊甌異當發皚盡監盤礦禮秈種稱穌穎窯競筆築簡籃粉絕綢維綿緊緻縣縮繽纜缽聖"
    ,
    "师萨学机电脑键盘网猫爱只风画写读说话语词译试谁请谢门问间闻开关飞马鸟鱼龙龟铁银钱钢录镜长车软轻轮运过达远选边邮页头颜题饭饮馆惊验骑发鲜鸭鹰麦黄点齿红纸级细终结给统绿线练组经总织绘续罗声职艺蓝旧节药虫兰虾术视觉观计讯记设证诗认调谈论讲识护让贝负财货质购赶较转鸡鹅贰云岛屿岭岩灵显腾鸣丽摄表灯烛烁烂狮猿兽环玛璃琼瓯异当发皑尽监盘矿礼籼种称稣颖窑竞笔筑简篮粉绝绸维绵紧致县缩缤缆钵圣"
)


# Curated Taiwan-phrase -> Mainland-phrase table (the *vocabulary* half of
# OpenCC tw2sp, which converts Taiwan-specific terms, not just glyphs).
# Keys are Traditional Taiwan forms and are replaced longest-first BEFORE
# the char table, so e.g. 滑鼠 becomes 鼠标 (mouse) instead of the
# char-level non-word 滑鼠.  ~130 entries covering the tech/daily-life
# vocabulary that actually reaches an image prompt.
_TW2SP_PHRASES = {
    # computing / electronics
    "軟體": "软件", "硬體": "硬件", "韌體": "固件", "程式碼": "代码",
    "原始碼": "源代码", "程式": "程序", "網際網路": "互联网",
    "全球資訊網": "万维网", "網路": "网络", "資訊": "信息",
    "資料庫": "数据库", "資料夾": "文件夹", "作業系統": "操作系统",
    "視窗": "窗口", "滑鼠": "鼠标", "印表機": "打印机",
    "掃描器": "扫描仪", "硬碟": "硬盘", "軟碟": "软盘", "光碟": "光盘",
    "磁碟": "磁盘", "隨身碟": "U盘", "記憶體": "内存", "快取": "缓存",
    "伺服器": "服务器", "部落格": "博客", "人工智慧": "人工智能",
    "智慧型手機": "智能手机", "行動電話": "移动电话",
    "行動裝置": "移动设备", "筆記型電腦": "笔记本电脑",
    "桌上型電腦": "台式电脑", "螢幕": "屏幕", "解析度": "分辨率",
    "畫素": "像素", "位元組": "字节", "位元": "比特", "數位": "数字",
    "類比訊號": "模拟信号", "演算法": "算法", "迴圈": "循环",
    "變數": "变量", "函式": "函数", "物件導向": "面向对象",
    "陣列": "数组", "字串": "字符串", "指標": "指针",
    "執行緒": "线程", "編譯器": "编译器", "直譯器": "解释器",
    "除錯": "调试", "當機": "死机", "連線": "连接", "登入": "登录",
    "登出": "注销", "帳號": "账号", "網咖": "网吧", "電玩": "电子游戏",
    "電晶體": "晶体管", "積體電路": "集成电路", "奈米": "纳米",
    "矽谷": "硅谷", "雷射": "激光", "影片": "视频",
    # transport / aerospace
    "捷運": "地铁", "計程車": "出租车", "腳踏車": "自行车",
    "機車": "摩托车", "公車": "公交车", "太空梭": "航天飞机",
    "太空人": "宇航员", "飛彈": "导弹", "幽浮": "飞碟",
    # food
    "鳳梨": "菠萝", "馬鈴薯": "土豆", "速食麵": "方便面",
    "泡麵": "方便面", "優酪乳": "酸奶", "優格": "酸奶", "起司": "奶酪",
    "便當": "盒饭", "鮭魚": "三文鱼", "洋芋片": "薯片",
    "花椰菜": "菜花", "奇異果": "猕猴桃",
    # school / office / daily life
    "幼稚園": "幼儿园", "國小": "小学", "國中": "初中",
    "冷氣機": "空调", "冷氣": "空调", "影印": "复印",
    "原子筆": "圆珠笔", "立可白": "修正液", "迴紋針": "回形针",
    "錄影帶": "录像带", "錄影機": "录像机", "攝影機": "摄像机",
    "洗髮精": "洗发水", "塑膠": "塑料", "保麗龍": "泡沫塑料",
    "提款機": "取款机", "郵遞區號": "邮政编码", "宅急便": "快递",
    "計算機概論": "计算机概论",  # before 計算機 (TW 計算機 = calculator)
    "計算機": "计算器", "電鍋": "电饭锅", "機板": "主板",
    "品質": "质量", "水準": "水平", "通路": "渠道", "行銷": "营销",
    "企劃": "策划", "履歷": "简历", "資遣": "裁员", "薪資": "工资",
    "幼兒園": "幼儿园", "貓熊": "熊猫", "窩心": "贴心",
    "土石流": "泥石流", "颱風眼": "台风眼",
}
DEFAULT_TW2SP_TSV = "data/opencc/tw2sp_phrases.tsv"


@functools.lru_cache(maxsize=4)
def _phrase_table(tsv_path: Optional[str]):
    """(phrases dict, longest-first regex) for the offline tw2sp fallback:
    the built-in curated phrases, overlaid and extended by a TSV of OpenCC's
    TWPhrases vocabulary when one is present (its entries win, since they
    carry OpenCC's exact tw2sp output)."""
    phrases = dict(_TW2SP_PHRASES)
    if tsv_path:
        try:
            with open(tsv_path, encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split("\t")
                    if len(parts) >= 2 and parts[0] and parts[1]:
                        phrases[parts[0]] = parts[1]
        except OSError as e:
            warnings.warn(f"tw2sp phrase asset unreadable ({e}); using the "
                          "built-in curated table only")
    regex = re.compile(
        "|".join(
            re.escape(k) for k in sorted(phrases, key=len, reverse=True)
        )
    )
    return phrases, regex


def _tw2sp_tsv_path() -> Optional[str]:
    path = os.environ.get("OPENCC_TW2SP_TSV", DEFAULT_TW2SP_TSV)
    return path if os.path.isfile(path) else None


def contains_zh(text: str) -> bool:
    """True when the text holds a CJK unified ideograph."""
    return bool(_ZH_RE.search(text))


def tw_to_simplified(text: str) -> str:
    """OpenCC tw2sp when it can be imported; else the phrase table (Taiwan
    vocabulary -> Mainland vocabulary, longest match first, see
    `_phrase_table`), then the character tables for the remaining
    glyphs."""
    try:
        from opencc import OpenCC  # optional dependency
    except ImportError:
        phrases, regex = _phrase_table(_tw2sp_tsv_path())
        text = regex.sub(lambda m: phrases[m.group(0)], text)
        return text.translate(_T2S).translate(_T2S_EXTRA)
    return OpenCC("tw2sp.json").convert(text)


MARIAN_SLOT = "marian_zh_en"


def default_translator(device=None) -> Optional[Callable[[str], str]]:
    """The default zh -> en translator: the port's MarianMT on `device`
    (default `cuda`), loaded through the zoo's gate from slot
    `marian_zh_en`, when that file and the tokenizer assets (`MARIAN_SPM_PATH`,
    `MARIAN_VOCAB_PATH`) are present; built once per (file, device).  None
    when either is absent.  The JAX package's orbax tree without the port's
    file raises (`zoo.provisioned_checkpoint`)."""
    from clip_diffusion_tpu_torch.models.marian import _assets
    from clip_diffusion_tpu_torch.utils.device import resolve_device
    from clip_diffusion_tpu_torch.zoo import provisioned_checkpoint

    path = provisioned_checkpoint(MARIAN_SLOT)
    if path is None or _assets()[0] is None:
        return None
    return _marian_translator(path, str(resolve_device(device)))


@functools.lru_cache(maxsize=4)
def _marian_translator(path: str, device: str) -> Callable[[str], str]:
    from clip_diffusion_tpu_torch.models.marian import marian_translator
    from clip_diffusion_tpu_torch.zoo import init_marian

    return marian_translator(init_marian(device=device,
                                         checkpoint_root=os.path.dirname(path)))


def translate_zh_to_en(
    text: str, translator: Optional[Callable[[str], str]] = None, device=None
) -> str:
    """zh -> en when the text contains Chinese, after tw2sp, through
    `translator`, else the default one on `device`.  Identity (with a
    warning) when no translator is available."""
    if not contains_zh(text):
        return text
    text = tw_to_simplified(text)
    translator = translator or default_translator(device)
    if translator is None:
        warnings.warn(
            "MarianMT zh->en weights unavailable; passing the prompt through "
            "untranslated. Provide a translator via Prompt(translator=...)."
        )
        return text
    return translator(text)

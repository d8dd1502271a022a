"""Hanzi coverage of the vendored pinyin table on a realistic Chinese text
sample (a copy of korean_f5_tts_tpu/scripts/pinyin_coverage.py over the
port's text/pinyin.py). Prints one JSON line:

    python -m korean_f5_tts_tpu_torch.scripts.pinyin_coverage

Coverage = the fraction of hanzi tokens that convert to a pinyin syllable
instead of falling through as the raw character (the reference's pypinyin
has full dictionary coverage; the vendored table is finite). The sample is
original running text across registers: news, narrative, dialogue, domestic
scenes, instructions.
"""

from __future__ import annotations

import json

from korean_f5_tts_tpu_torch.text.pinyin import convert_char_to_pinyin

SAMPLE = (
    "今年以来，全国各地持续推进经济高质量发展，新能源汽车、人工智能等产业快速增长。"
    "专家表示，随着政策落地见效，市场信心明显增强，消费需求稳步回升。"
    "昨天下午，我和朋友一起去电影院看了一部新电影，故事情节非常感人，我们都流下了眼泪。"
    "走出影院的时候，天空下起了小雨，街道上的行人撑着五颜六色的雨伞，匆匆忙忙地赶路。"
    "妈妈在厨房里做饭，香味飘满了整个屋子。爸爸坐在沙发上看报纸，妹妹在写作业。"
    "老师告诉我们，学习语言需要坚持不懈的努力，每天坚持阅读和练习，才能取得进步。"
    "这家餐厅的菜品味道很好，价格也比较便宜，服务员态度热情，值得推荐给大家。"
    "科学家们经过多年的研究，终于发现了这种疾病的治疗方法，给无数患者带来了希望。"
    "秋天到了，树叶渐渐变黄，农民伯伯开始收割庄稼，田野里一片丰收的景象。"
    "他从小就喜欢音乐，长大后成为了一名著名的钢琴家，经常在世界各地举办演奏会。"
    "请问去火车站怎么走？您先直走，到红绿灯路口右转，再走大约五百米就到了。"
    "公司决定下个月召开年度会议，讨论明年的发展计划和预算安排，请各部门做好准备。"
    "春节是中国最重要的传统节日，家家户户贴春联、包饺子、放鞭炮，热闹非凡。"
    "随着互联网技术的飞速发展，越来越多的人选择在网上购物、学习和工作。"
    "医生建议他多锻炼身体，保持良好的生活习惯，少吃油腻食物，早睡早起。"
    "图书馆里安静极了，同学们都在认真地复习功课，准备即将到来的期末考试。"
    "这座城市的夜景特别美丽，高楼大厦灯火辉煌，江边的步行街挤满了游客。"
    "环境保护是每个人的责任，我们应该节约用水用电，减少垃圾，爱护花草树木。"
    "足球比赛进行得十分激烈，双方队员奋力拼搏，最终主队以二比一获得胜利。"
    "奶奶年纪大了，但身体依然健康，每天早晨都去公园打太极拳，晚上散步。"
    "飞机因为天气原因延误了三个小时，乘客们只好在候机厅里耐心等待。"
    "历史博物馆展出了许多珍贵的文物，吸引了来自世界各地的参观者。"
    "银行工作人员提醒大家注意防范电信诈骗，不要轻易透露个人信息和密码。"
    "政府出台了一系列措施支持中小企业发展，降低税费负担，优化营商环境。"
    "她穿着一条红色的裙子，站在舞台中央唱歌，声音清脆动听，赢得阵阵掌声。"
    "弟弟考上了理想的大学，全家人都为他感到骄傲，爷爷特意做了一桌好菜庆祝。"
)


def main(sample: str = SAMPLE) -> dict:
    """Print the coverage of `sample` as one JSON line and return it."""
    hanzi = [c for c in sample if "\u3400" <= c <= "\u9fff"]
    out = convert_char_to_pinyin([sample])[0]
    raw = [t for t in out if any("\u3400" <= c <= "\u9fff" for c in t)]
    result = {
        "sample_hanzi_tokens": len(hanzi),
        "sample_distinct_hanzi": len(set(hanzi)),
        "raw_passthrough_tokens": len(raw),
        "raw_passthrough_chars": "".join(sorted(set(raw))),
        "token_coverage": round(1.0 - len(raw) / len(hanzi), 4),
    }
    print(json.dumps(result, ensure_ascii=False))
    return result


if __name__ == "__main__":
    main()

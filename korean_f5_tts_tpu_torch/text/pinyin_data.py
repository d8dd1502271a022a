"""Vendored hanzi→pinyin table (offline stand-in for pypinyin).

The reference converts Chinese text with jieba + pypinyin
(`model/utils.py:481-518`, lazy_pinyin Style.TONE3 tone_sandhi=True). Neither
library ships in this image, so this module vendors:

  - CHAR_READINGS: the most-frequent simplified hanzi with their most common
    Mandarin reading in TONE3 format (syllable + tone digit), covering normal
    running text. Readings are standard-Mandarin dictionary values (public
    linguistic facts, same inventory as the Emilia_ZH_EN_pinyin vocab).
  - WORD_OVERRIDES: common polyphone words whose per-character defaults would
    be wrong (e.g. 银行 -> yin2 hang2).
  - apply_tone_sandhi: the 不/一 tone rules and third-tone (3-3 -> 2-3)
    sandhi pypinyin applies with tone_sandhi=True. Without jieba the sandhi
    window is the contiguous hanzi run instead of the jieba word — a
    documented approximation (PARITY.md).

Every emitted syllable is a member of the reference's pinyin vocab
(data/Emilia_ZH_EN_pinyin/vocab.txt of the reference); golden-tested in
tests/test_pinyin_vendored.py.
"""

from __future__ import annotations

import functools

# "char reading" per line; first (most common) reading only — polyphones that
# commonly need another reading in compounds are handled by WORD_OVERRIDES.
_TABLE = """
的 de
一 yi1
是 shi4
不 bu4
了 le
人 ren2
我 wo3
在 zai4
有 you3
他 ta1
这 zhe4
中 zhong1
大 da4
来 lai2
上 shang4
国 guo2
个 ge4
到 dao4
说 shuo1
们 men
为 wei4
子 zi3
和 he2
你 ni3
地 di4
出 chu1
道 dao4
也 ye3
时 shi2
年 nian2
得 de
就 jiu4
那 na4
要 yao4
下 xia4
以 yi3
生 sheng1
会 hui4
自 zi4
着 zhe
去 qu4
之 zhi1
过 guo4
家 jia1
学 xue2
对 dui4
可 ke3
她 ta1
里 li3
后 hou4
小 xiao3
么 me
心 xin1
多 duo1
天 tian1
而 er2
能 neng2
好 hao3
都 dou1
然 ran2
没 mei2
日 ri4
于 yu2
起 qi3
还 hai2
发 fa1
成 cheng2
事 shi4
只 zhi3
作 zuo4
当 dang1
想 xiang3
看 kan4
文 wen2
无 wu2
开 kai1
手 shou3
十 shi2
用 yong4
主 zhu3
行 xing2
方 fang1
又 you4
如 ru2
前 qian2
所 suo3
本 ben3
见 jian4
经 jing1
头 tou2
面 mian4
公 gong1
同 tong2
三 san1
已 yi3
老 lao3
从 cong2
动 dong4
两 liang3
长 chang2
知 zhi1
民 min2
样 yang4
现 xian4
分 fen1
将 jiang1
外 wai4
但 dan4
身 shen1
些 xie1
与 yu3
高 gao1
意 yi4
进 jin4
把 ba3
法 fa3
此 ci3
实 shi2
回 hui2
二 er4
理 li3
美 mei3
点 dian3
月 yue4
明 ming2
其 qi2
种 zhong3
声 sheng1
全 quan2
工 gong1
己 ji3
话 hua4
儿 er2
者 zhe3
向 xiang4
情 qing2
部 bu4
正 zheng4
名 ming2
定 ding4
女 nv3
问 wen4
力 li4
机 ji1
给 gei3
等 deng3
几 ji3
很 hen3
业 ye4
最 zui4
间 jian1
新 xin1
什 shen2
打 da3
便 bian4
位 wei4
因 yin1
重 zhong4
被 bei4
走 zou3
电 dian4
四 si4
第 di4
门 men2
相 xiang1
次 ci4
东 dong1
政 zheng4
海 hai3
口 kou3
使 shi3
教 jiao4
西 xi1
再 zai4
平 ping2
真 zhen1
听 ting1
世 shi4
气 qi4
信 xin4
北 bei3
少 shao3
关 guan1
并 bing4
内 nei4
加 jia1
化 hua4
由 you2
却 que4
代 dai4
军 jun1
产 chan3
入 ru4
先 xian1
山 shan1
五 wu3
太 tai4
水 shui3
万 wan4
市 shi4
眼 yan3
体 ti3
别 bie2
处 chu4
总 zong3
才 cai2
场 chang3
师 shi1
书 shu1
比 bi3
住 zhu4
员 yuan2
九 jiu3
笑 xiao4
性 xing4
通 tong1
目 mu4
华 hua2
报 bao4
立 li4
马 ma3
命 ming4
张 zhang1
活 huo2
难 nan2
神 shen2
数 shu4
件 jian4
安 an1
表 biao3
原 yuan2
车 che1
白 bai2
应 ying1
路 lu4
期 qi1
叫 jiao4
死 si3
常 chang2
提 ti2
感 gan3
金 jin1
何 he2
更 geng4
反 fan3
题 ti2
必 bi4
却 que4
论 lun4
或 huo4
及 ji2
今 jin1
司 si1
票 piao4
房 fang2
色 se4
战 zhan4
士 shi4
音 yin1
界 jie4
任 ren4
连 lian2
条 tiao2
直 zhi2
做 zuo4
队 dui4
结 jie2
领 ling3
七 qi1
究 jiu1
结 jie2
八 ba1
代 dai4
快 kuai4
解 jie3
府 fu3
特 te4
流 liu2
每 mei3
像 xiang4
员 yuan2
接 jie1
社 she4
元 yuan2
风 feng1
程 cheng2
收 shou1
根 gen1
六 liu4
百 bai3
放 fang4
变 bian4
科 ke1
王 wang2
管 guan3
受 shou4
指 zhi3
思 si1
格 ge2
拉 la1
望 wang4
觉 jue2
爱 ai4
术 shu4
区 qu1
钱 qian2
服 fu2
字 zi4
清 qing1
权 quan2
件 jian4
句 ju4
品 pin3
式 shi4
单 dan1
需 xu1
海 hai3
交 jiao1
持 chi2
排 pai2
准 zhun3
布 bu4
易 yi4
河 he2
团 tuan2
称 cheng1
语 yu3
容 rong2
照 zhao4
非 fei1
调 diao4
底 di3
班 ban1
复 fu4
办 ban4
父 fu4
夫 fu1
视 shi4
热 re4
决 jue2
客 ke4
价 jia4
史 shi3
母 mu3
改 gai3
据 ju4
带 dai4
歌 ge1
微 wei1
留 liu2
读 du2
哪 na3
速 su4
设 she4
友 you3
令 ling4
深 shen1
却 que4
识 shi2
青 qing1
争 zheng1
息 xi1
火 huo3
济 ji4
近 jin4
站 zhan4
远 yuan3
越 yue4
观 guan1
落 luo4
即 ji2
护 hu4
强 qiang2
极 ji2
满 man3
风 feng1
轻 qing1
纪 ji4
施 shi1
游 you2
久 jiu3
市 shi4
医 yi1
突 tu1
阵 zhen4
词 ci2
城 cheng2
早 zao3
排 pai2
运 yun4
终 zhong1
售 shou4
层 ceng2
黑 hei1
虽 sui1
推 tui1
迎 ying2
约 yue1
卖 mai4
买 mai3
希 xi1
周 zhou1
试 shi4
节 jie2
德 de2
传 chuan2
且 qie3
型 xing2
兵 bing1
健 jian4
康 kang1
星 xing1
光 guang1
电 dian4
乐 le4
短 duan3
线 xian4
让 rang4
费 fei4
票 piao4
某 mou3
精 jing1
树 shu4
菜 cai4
鱼 yu2
肉 rou4
鸡 ji1
牛 niu2
羊 yang2
猪 zhu1
米 mi3
面 mian4
茶 cha2
酒 jiu3
咖 ka1
啡 fei1
糖 tang2
盐 yan2
油 you2
汤 tang1
饭 fan4
菌 jun1
蛋 dan4
奶 nai3
水 shui3
果 guo3
苹 ping2
梨 li2
桃 tao2
葡 pu2
萄 tao2
西 xi1
瓜 gua1
草 cao3
花 hua1
叶 ye4
根 gen1
春 chun1
夏 xia4
秋 qiu1
冬 dong1
冷 leng3
暖 nuan3
凉 liang2
雨 yu3
雪 xue3
云 yun2
雷 lei2
电 dian4
风 feng1
晴 qing2
阴 yin1
雾 wu4
冰 bing1
火 huo3
土 tu3
石 shi2
沙 sha1
江 jiang1
湖 hu2
海 hai3
洋 yang2
岛 dao3
岸 an4
桥 qiao2
街 jie1
巷 xiang4
楼 lou2
层 ceng2
房 fang2
屋 wu1
门 men2
窗 chuang1
墙 qiang2
床 chuang2
桌 zhuo1
椅 yi3
灯 deng1
镜 jing4
杯 bei1
盘 pan2
碗 wan3
筷 kuai4
刀 dao1
叉 cha1
勺 shao2
瓶 ping2
盒 he2
箱 xiang1
包 bao1
袋 dai4
衣 yi1
裤 ku4
裙 qun2
鞋 xie2
袜 wa4
帽 mao4
伞 san3
表 biao3
钟 zhong1
镑 bang4
币 bi4
银 yin2
铁 tie3
铜 tong2
金 jin1
玉 yu4
珠 zhu1
宝 bao3
贵 gui4
便 bian4
宜 yi2
贱 jian4
穷 qiong2
富 fu4
贫 pin2
财 cai2
货 huo4
商 shang1
店 dian4
购 gou4
卖 mai4
租 zu1
借 jie4
还 hai2
欠 qian4
付 fu4
账 zhang4
税 shui4
利 li4
率 lv4
险 xian3
保 bao3
证 zheng4
券 quan4
股 gu3
基 ji1
投 tou2
资 zi1
贸 mao4
市 shi4
场 chang3
厂 chang3
矿 kuang4
农 nong2
林 lin2
牧 mu4
渔 yu2
猎 lie4
织 zhi1
纺 fang3
染 ran3
缝 feng2
修 xiu1
建 jian4
筑 zhu4
装 zhuang1
拆 chai1
挖 wa1
填 tian2
铺 pu1
砌 qi4
刷 shua1
漆 qi1
钉 ding1
锯 ju4
磨 mo2
切 qie1
割 ge1
剪 jian3
削 xiao1
刮 gua1
插 cha1
拔 ba2
抽 chou1
推 tui1
拉 la1
提 ti2
抬 tai2
扛 kang2
背 bei1
抱 bao4
搬 ban1
运 yun4
送 song4
递 di4
扔 reng1
丢 diu1
捡 jian3
拾 shi2
摸 mo1
碰 peng4
撞 zhuang4
打 da3
敲 qiao1
拍 pai1
踢 ti1
踩 cai3
跳 tiao4
跑 pao3
走 zou3
爬 pa2
站 zhan4
坐 zuo4
躺 tang3
睡 shui4
醒 xing3
梦 meng4
哭 ku1
笑 xiao4
喊 han3
叫 jiao4
唱 chang4
跳 tiao4
舞 wu3
画 hua4
写 xie3
读 du2
念 nian4
背 bei4
记 ji4
忘 wang4
想 xiang3
思 si1
考 kao3
算 suan4
数 shu3
量 liang4
称 cheng1
测 ce4
验 yan4
查 cha2
找 zhao3
寻 xun2
发 fa1
现 xian4
研 yan2
究 jiu1
探 tan4
索 suo3
观 guan1
察 cha2
注 zhu4
视 shi4
盯 ding1
瞧 qiao2
瞄 miao2
瞪 deng4
眨 zha3
闭 bi4
睁 zheng1
听 ting1
闻 wen2
嗅 xiu4
尝 chang2
吃 chi1
喝 he1
咬 yao3
嚼 jiao2
吞 tun1
咽 yan4
吐 tu4
呕 ou3
喘 chuan3
咳 ke2
嗽 sou4
打 da3
喷 pen1
嚏 ti4
哈 ha1
欠 qian4
疼 teng2
痛 tong4
痒 yang3
酸 suan1
麻 ma2
肿 zhong3
伤 shang1
病 bing4
药 yao4
医 yi1
治 zhi4
疗 liao2
救 jiu4
护 hu4
养 yang3
休 xiu1
息 xi1
健 jian4
康 kang1
弱 ruo4
病 bing4
死 si3
活 huo2
命 ming4
岁 sui4
婚 hun1
嫁 jia4
娶 qu3
育 yu4
孕 yun4
产 chan3
养 yang3
育 yu4
孩 hai2
婴 ying1
童 tong2
少 shao4
青 qing1
壮 zhuang4
成 cheng2
熟 shu2
幼 you4
嫩 nen4
鲜 xian1
新 xin1
旧 jiu4
老 lao3
古 gu3
今 jin1
昔 xi1
晨 chen2
晚 wan3
夜 ye4
午 wu3
昨 zuo2
明 ming2
刻 ke4
秒 miao3
钟 zhong1
点 dian3
旬 xun2
季 ji4
度 du4
世 shi4
纪 ji4
代 dai4
期 qi1
限 xian4
久 jiu3
暂 zan4
永 yong3
恒 heng2
瞬 shun4
顷 qing3
刹 cha4
始 shi3
末 mo4
初 chu1
终 zhong1
先 xian1
末 mo4
首 shou3
尾 wei3
顶 ding3
底 di3
表 biao3
里 li3
内 nei4
外 wai4
左 zuo3
右 you4
旁 pang2
边 bian1
角 jiao3
侧 ce4
邻 lin2
隔 ge2
距 ju4
离 li2
遥 yao2
朝 chao2
向 xiang4
往 wang3
返 fan3
回 hui2
归 gui1
退 tui4
进 jin4
升 sheng1
降 jiang4
沉 chen2
浮 fu2
漂 piao1
流 liu2
淌 tang3
滴 di1
洒 sa3
泼 po1
浇 jiao1
灌 guan4
泡 pao4
浸 jin4
洗 xi3
涮 shuan4
擦 ca1
抹 mo3
扫 sao3
拖 tuo1
吸 xi1
尘 chen2
垃 la1
圾 ji1
脏 zang1
净 jing4
洁 jie2
污 wu1
染 ran3
环 huan2
境 jing4
保 bao3
护 hu4
绿 lv4
红 hong2
黄 huang2
蓝 lan2
紫 zi3
粉 fen3
灰 hui1
棕 zong1
橙 cheng2
彩 cai3
颜 yan2
浅 qian3
淡 dan4
浓 nong2
艳 yan4
亮 liang4
暗 an4
明 ming2
辉 hui1
煌 huang2
灿 can4
烂 lan4
闪 shan3
耀 yao4
映 ying4
反 fan3
射 she4
烁 shuo4
晶 jing1
莹 ying2
透 tou4
质 zhi4
软 ruan3
硬 ying4
松 song1
紧 jin3
粗 cu1
细 xi4
厚 hou4
薄 bao2
宽 kuan1
窄 zhai3
胖 pang4
瘦 shou4
高 gao1
矮 ai3
低 di1
壮 zhuang4
苗 miao2
美 mei3
丑 chou3
俊 jun4
秀 xiu4
雅 ya3
帅 shuai4
漂 piao4
酷 ku4
萌 meng2
可 ke3
怕 pa4
恐 kong3
惧 ju4
惊 jing1
吓 xia4
慌 huang1
忙 mang2
急 ji2
躁 zao4
烦 fan2
恼 nao3
怒 nu4
气 qi4
愤 fen4
恨 hen4
怨 yuan4
仇 chou2
嫉 ji2
妒 du4
羡 xian4
慕 mu4
敬 jing4
佩 pei4
赞 zan4
夸 kua1
捧 peng3
贬 bian3
骂 ma4
批 pi1
评 ping2
议 yi4
论 lun4
谈 tan2
聊 liao2
讲 jiang3
述 shu4
叙 xu4
描 miao2
绘 hui4
形 xing2
状 zhuang4
圆 yuan2
方 fang1
扁 bian3
尖 jian1
钝 dun4
弯 wan1
曲 qu1
折 zhe2
叠 die2
卷 juan3
展 zhan3
铺 pu1
盖 gai4
遮 zhe1
挡 dang3
掩 yan3
藏 cang2
躲 duo3
逃 tao2
避 bi4
追 zhui1
赶 gan3
逐 zhu2
捉 zhuo1
抓 zhua1
捕 bu3
猎 lie4
钓 diao4
网 wang3
笼 long2
关 guan1
锁 suo3
封 feng1
贴 tie1
粘 zhan1
绑 bang3
系 xi4
捆 kun3
扎 zha1
套 tao4
穿 chuan1
脱 tuo1
戴 dai4
摘 zhai1
挂 gua4
吊 diao4
悬 xuan2
垂 chui2
飘 piao1
扬 yang2
挥 hui1
摇 yao2
晃 huang4
摆 bai3
抖 dou3
颤 chan4
震 zhen4
响 xiang3
吵 chao3
闹 nao4
静 jing4
安 an1
宁 ning2
稳 wen3
牢 lao2
固 gu4
坚 jian1
脆 cui4
嫩 nen4
烂 lan4
腐 fu3
朽 xiu3
锈 xiu4
损 sun3
坏 huai4
破 po4
碎 sui4
裂 lie4
断 duan4
残 can2
缺 que1
完 wan2
整 zheng3
齐 qi2
全 quan2
满 man3
盈 ying2
空 kong1
虚 xu1
零 ling2
余 yu2
剩 sheng4
增 zeng1
添 tian1
补 bu3
减 jian3
扣 kou4
除 chu2
乘 cheng2
加 jia1
率 lv4
倍 bei4
半 ban4
双 shuang1
对 dui4
单 dan1
独 du2
孤 gu1
群 qun2
众 zhong4
伙 huo3
伴 ban4
朋 peng2
友 you3
敌 di2
仇 chou2
师 shi1
徒 tu2
生 sheng1
客 ke4
宾 bin1
主 zhu3
仆 pu2
奴 nu2
臣 chen2
君 jun1
帝 di4
皇 huang2
后 hou4
妃 fei1
公 gong1
侯 hou2
将 jiang1
相 xiang4
官 guan1
吏 li4
兵 bing1
卒 zu2
警 jing3
察 cha2
律 lv4
规 gui1
章 zhang1
制 zhi4
令 ling4
禁 jin4
止 zhi3
允 yun3
许 xu3
准 zhun3
批 pi1
罚 fa2
惩 cheng2
奖 jiang3
赏 shang3
罪 zui4
犯 fan4
嫌 xian2
疑 yi2
审 shen3
判 pan4
裁 cai2
决 jue2
狱 yu4
囚 qiu2
释 shi4
赦 she4
逮 dai4
拘 ju1
押 ya1
枪 qiang1
炮 pao4
弹 dan4
箭 jian4
弓 gong1
刀 dao1
剑 jian4
矛 mao2
盾 dun4
甲 jia3
盔 kui1
旗 qi2
鼓 gu3
号 hao4
哨 shao4
营 ying2
寨 zhai4
堡 bao3
垒 lei3
壕 hao2
沟 gou1
墙 qiang2
城 cheng2
池 chi2
塔 ta3
庙 miao4
寺 si4
宫 gong1
殿 dian4
堂 tang2
馆 guan3
院 yuan4
校 xiao4
园 yuan2
所 suo3
室 shi4
厅 ting1
厨 chu2
厕 ce4
卫 wei4
浴 yu4
卧 wo4
客 ke4
餐 can1
书 shu1
办 ban4
会 hui4
仓 cang1
库 ku4
棚 peng2
亭 ting2
廊 lang2
阶 jie1
梯 ti1
栏 lan2
杆 gan1
柱 zhu4
梁 liang2
檐 yan2
瓦 wa3
砖 zhuan1
泥 ni2
灰 hui1
浆 jiang1
板 ban3
木 mu4
竹 zhu2
藤 teng2
绳 sheng2
索 suo3
链 lian4
丝 si1
线 xian4
布 bu4
绸 chou2
缎 duan4
棉 mian2
麻 ma2
毛 mao2
皮 pi2
革 ge2
毡 zhan1
呢 ne
绒 rong2
纱 sha1
纸 zhi3
墨 mo4
笔 bi3
砚 yan4
刊 kan1
版 ban3
页 ye4
册 ce4
卷 juan4
篇 pian1
段 duan4
行 hang2
栏 lan2
题 ti2
序 xu4
跋 ba2
注 zhu4
评 ping2
译 yi4
编 bian1
著 zhu4
撰 zhuan4
抄 chao1
誊 teng2
印 yin4
刷 shua1
装 zhuang1
订 ding4
档 dang4
案 an4
簿 bu4
帐 zhang4
"""

# round-5 supplement: gaps found by running realistic ZH corpus samples and
# broad domain sweeps (family/body/animals/food/weather/verbs/etc.) through
# the table — all standard-Mandarin dictionary readings (most-common/pypinyin
# default first reading; compound-specific readings go in WORD_OVERRIDES)
_TABLE2 = """
专 zhuan1
丰 feng1
丽 li4
举 ju3
习 xi2
互 hu4
企 qi3
优 you1
伯 bo2
依 yi1
候 hou4
值 zhi2
傲 ao4
凡 fan2
划 hua4
列 lie4
功 gong1
务 wu4
努 nu3
匆 cong1
博 bo2
历 li4
厦 sha4
参 can1
取 qu3
召 zhao4
台 tai2
各 ge4
告 gao4
味 wei4
喜 xi3
图 tu2
备 bei4
央 yang1
奋 fen4
奏 zou4
妈 ma1
妹 mei4
密 mi4
庄 zhuang1
庆 qing4
座 zuo4
延 yan2
引 yin3
弟 di4
影 ying3
待 dai4
态 tai4
怎 zen3
患 huan4
您 nin2
惯 guan4
懈 xie4
户 hu4
技 ji4
担 dan1
择 ze2
拳 quan2
拼 pin1
挤 ji3
掌 zhang3
措 cuo4
搏 bo2
撑 cheng1
支 zhi1
故 gu4
效 xiao4
散 san4
显 xian3
景 jing3
智 zhi4
欢 huan1
步 bu4
求 qiu2
汽 qi4
泪 lei4
消 xiao1
渐 jian4
源 yuan2
演 yan3
激 ji1
炼 lian4
烈 lie4
爷 ye2
爸 ba4
片 pian4
物 wu4
珍 zhen1
球 qiu2
琴 qin2
田 tian2
疾 ji2
码 ma3
示 shi4
祝 zhu4
稼 jia4
策 ce4
练 lian4
统 tong3
续 xu4
耐 nai4
联 lian2
胜 sheng4
腻 ni4
良 liang2
范 fan4
荐 jian4
获 huo4
言 yan2
计 ji4
认 ren4
讨 tao3
诈 zha4
诉 su4
该 gai1
误 wu4
请 qing3
象 xiang4
负 fu4
责 ze2
赛 sai4
赢 ying2
足 zu2
转 zhuan3
较 jiao4
选 xuan3
野 ye3
钢 gang1
锻 duan4
阅 yue4
防 fang2
随 sui2
露 lu4
鞭 bian1
预 yu4
飞 fei1
食 shi2
饺 jiao3
香 xiang1
骄 jiao1
骗 pian4
虎 hu3
览 lan3
谢 xie4
京 jing1
亿 yi4
仟 qian1
伍 wu3
佰 bai3
侄 zhi2
兄 xiong1
兔 tu4
凤 feng4
剁 duo4
剥 bo1
南 nan2
叁 san1
叔 shu1
吟 yin2
吼 hou3
呼 hu1
咸 xian2
唇 chun2
喃 nan2
嘴 zui3
嚎 hao2
塑 su4
壶 hu2
壹 yi1
妇 fu4
妻 qi1
姐 jie3
姑 gu1
姨 yi2
婶 shen3
媳 xi2
孙 sun1
巾 jin1
帘 lian2
戒 jie4
扶 fu2
拌 ban4
挑 tiao1
捌 ba1
捏 nie1
捣 dao3
掷 zhi4
揉 rou2
握 wo4
搀 chan1
搂 lou3
搓 cuo1
携 xie2
摔 shuai1
晒 shai4
柒 qi1
柜 gui4
桶 tong3
梳 shu1
榨 zha4
泳 yong3
淋 lin2
漱 shu4
灶 zao4
炉 lu2
炒 chao3
炖 dun4
炸 zha4
烤 kao3
烫 tang4
焖 men4
煮 zhu3
熊 xiong2
熬 ao2
燕 yan4
牙 ya2
狗 gou3
狮 shi1
狼 lang2
猫 mao1
猴 hou2
玖 jiu3
甜 tian2
皂 zao4
盆 pen2
眉 mei2
睫 jie2
罐 guan4
耳 er3
肆 si4
肌 ji1
肘 zhou3
肝 gan1
肠 chang2
肤 fu1
肩 jian1
肺 fei4
肾 shen4
胃 wei4
胸 xiong1
脉 mai4
脑 nao3
脚 jiao3
脸 lian3
腌 yan1
腕 wan4
腥 xing1
腰 yao1
腹 fu4
腿 tui3
膝 xi1
臀 tun2
臂 bi4
臭 chou4
舅 jiu4
舌 she2
舔 tian3
苦 ku3
蒸 zheng1
虹 hong2
虾 xia1
蚁 yi3
蚊 wen2
蛇 she2
蜂 feng1
蝇 ying2
蝶 die2
蟹 xie4
血 xue4
衫 shan1
袖 xiu4
诵 song4
豹 bao4
贰 er4
趾 zhi3
踝 huai2
辣 la4
酿 niang4
锅 guo1
镯 zhuo2
附 fu4
陆 lu4
雀 que4
雕 diao1
雹 bao2
霜 shuang1
霞 xia2
颊 jia2
额 e2
骨 gu3
鸟 niao3
鸭 ya1
鹅 e2
鹰 ying1
鹿 lu4
默 mo4
鼠 shu3
鼻 bi2
龙 long2
龟 gui1
丘 qiu1
丸 wan2
乡 xiang1
假 jia3
剧 ju4
勇 yong3
勤 qin2
千 qian1
县 xian4
吗 ma
吧 ba
呀 ya
呵 he1
哎 ai1
哟 yo1
哦 o2
哲 zhe2
唉 ai1
啊 a
啤 pi2
啦 la
喂 wei4
善 shan4
喔 o1
嘛 ma
嘿 hei1
噢 o1
器 qi4
坡 po1
峰 feng1
忧 you1
忽 hu1
悲 bei1
惰 duo4
愁 chou2
愚 yu2
慎 shen4
慢 man4
懒 lan3
戏 xi4
摄 she4
敢 gan3
晕 yun1
村 cun1
枣 zao3
栗 li4
森 sen1
橘 ju2
款 kuan3
泉 quan2
泻 xie4
港 gang3
湾 wan1
溪 xi1
漠 mo4
瀑 pu4
灸 jiu3
烧 shao1
症 zheng4
监 jian1
省 sheng3
粥 zhou1
糕 gao1
络 luo4
缓 huan3
聪 cong1
航 hang2
舶 bo2
船 chuan2
蕉 jiao1
蠢 chun3
诊 zhen3
诗 shi1
诚 cheng2
谦 qian1
谨 jin3
谷 gu3
贷 dai4
赔 pei2
赚 zhuan4
蹈 dao3
迅 xun4
邮 you2
酱 jiang4
醋 cu4
针 zhen1
镇 zhen4
闷 men4
陵 ling2
隧 sui4
频 pin2
饼 bing3
模 mo2
课 ke4
"""

# common polyphone words whose per-char defaults would be wrong
WORD_OVERRIDES = {
    "银行": ["yin2", "hang2"],
    "行业": ["hang2", "ye4"],
    "行列": ["hang2", "lie4"],
    "一行": ["yi4", "hang2"],
    "成长": ["cheng2", "zhang3"],
    "长大": ["zhang3", "da4"],
    "校长": ["xiao4", "zhang3"],
    "市长": ["shi4", "zhang3"],
    "音乐": ["yin1", "yue4"],
    "乐器": ["yue4", "qi4"],
    "快乐": ["kuai4", "le4"],
    "重新": ["chong2", "xin1"],
    "重复": ["chong2", "fu4"],
    "还有": ["hai2", "you3"],
    "还是": ["hai2", "shi4"],
    "归还": ["gui1", "huan2"],
    "还钱": ["huan2", "qian2"],
    "得到": ["de2", "dao4"],
    "觉得": ["jue2", "de"],
    "得意": ["de2", "yi4"],
    "土地": ["tu3", "di4"],
    "地方": ["di4", "fang1"],
    "首都": ["shou3", "du1"],
    "都市": ["du1", "shi4"],
    "为了": ["wei4", "le"],
    "认为": ["ren4", "wei2"],
    "因为": ["yin1", "wei4"],
    "作为": ["zuo4", "wei2"],
    "行为": ["xing2", "wei2"],
    "了解": ["liao3", "jie3"],
    "会计": ["kuai4", "ji4"],
    "便宜": ["pian2", "yi"],
    "方便": ["fang1", "bian4"],
    "教书": ["jiao1", "shu1"],
    "教室": ["jiao4", "shi4"],
    "睡觉": ["shui4", "jiao4"],
    "觉醒": ["jue2", "xing3"],
    "中间": ["zhong1", "jian1"],
    "中奖": ["zhong4", "jiang3"],
    "种地": ["zhong4", "di4"],
    "背包": ["bei1", "bao1"],
    "背后": ["bei4", "hou4"],
    "数学": ["shu4", "xue2"],
    "数数": ["shu3", "shu4"],
    "干净": ["gan1", "jing4"],
    "干活": ["gan4", "huo2"],
    "朝阳": ["chao2", "yang2"],
    "朝鲜": ["chao2", "xian3"],
    "调查": ["diao4", "cha2"],
    "调整": ["tiao2", "zheng3"],
    "空调": ["kong1", "tiao2"],
    "什么": ["shen2", "me"],
    "的确": ["di2", "que4"],
    "目的": ["mu4", "di4"],
    # round-5 additions (default-reading corrections found by the
    # hand-derived goldens / corpus sweep)
    "重庆": ["chong2", "qing4"],
    "划船": ["hua2", "chuan2"],
    "划算": ["hua2", "suan4"],
    "假期": ["jia4", "qi1"],
    "放假": ["fang4", "jia4"],
    "请假": ["qing3", "jia4"],
    "暑假": ["shu3", "jia4"],
    "寒假": ["han2", "jia4"],
    "油炸": ["you2", "zha2"],
    "炸鸡": ["zha2", "ji1"],
    "大厦": ["da4", "sha4"],
    "厦门": ["xia4", "men2"],
    "血液": ["xue4", "ye4"],
    "流血": ["liu2", "xue4"],
    "头发": ["tou2", "fa4"],
    "理发": ["li3", "fa4"],
    "散步": ["san4", "bu4"],
    "散文": ["san3", "wen2"],
    "解散": ["jie3", "san4"],
    "松散": ["song1", "san3"],
    # 子/头-suffix neutral tone (pypinyin phrase dict semantics: TONE3 drops
    # the digit on neutral syllables — 日子 -> ri4 zi)
    "日子": ["ri4", "zi"],
    "孩子": ["hai2", "zi"],
    "桌子": ["zhuo1", "zi"],
    "椅子": ["yi3", "zi"],
    "房子": ["fang2", "zi"],
    "儿子": ["er2", "zi"],
    "样子": ["yang4", "zi"],
    "妻子": ["qi1", "zi"],
    "石头": ["shi2", "tou"],
    "木头": ["mu4", "tou"],
    # kinship reduplication neutralizes the second syllable for exactly the
    # pairs whose neutral form exists in the Emilia vocab (ma/ba present;
    # xie/di/jie absent -> pypinyin emitted full-tone there, no override)
    "妈妈": ["ma1", "ma"],
    "爸爸": ["ba4", "ba"],
}


@functools.lru_cache(maxsize=1)
def char_table() -> dict:
    table = {}
    for line in (_TABLE.strip().splitlines()
                 + _TABLE2.strip().splitlines()):
        parts = line.split()
        if len(parts) != 2 or parts[1] == "skip":
            continue
        ch, reading = parts
        if len(ch) == 1 and "㐀" <= ch <= "鿿" and ch not in table:
            table[ch] = reading
    return table


def _tone(s: str) -> int:
    return int(s[-1]) if s and s[-1].isdigit() else 0


def apply_tone_sandhi(sylls: list[str], chars: str) -> list[str]:
    """不/一 tone rules + third-tone sandhi (pypinyin tone_sandhi=True
    semantics, applied over the contiguous hanzi run)."""
    out = list(sylls)
    n = len(out)
    for i, c in enumerate(chars):
        nxt = _tone(out[i + 1]) if i + 1 < n else 0
        if c == "不":
            out[i] = "bu2" if nxt == 4 else "bu4"
        elif c == "一":
            if nxt == 4:
                out[i] = "yi2"
            elif nxt in (1, 2, 3):
                out[i] = "yi4"
    # 3-3 -> 2-3, right to left so runs of three resolve like pypinyin
    for i in range(n - 2, -1, -1):
        if _tone(out[i]) == 3 and _tone(out[i + 1]) == 3:
            out[i] = out[i][:-1] + "2"
    return out


def hanzi_to_pinyin(seg: str) -> list[str]:
    """TONE3 pinyin for a hanzi run; non-hanzi chars pass through.
    Word overrides first (longest-match scan), then per-char defaults."""
    table = char_table()
    sylls: list[str] = []
    i = 0
    while i < len(seg):
        matched = False
        for ln in (4, 3, 2):
            w = seg[i:i + ln]
            if w in WORD_OVERRIDES:
                sylls += WORD_OVERRIDES[w]
                i += ln
                matched = True
                break
        if not matched:
            sylls.append(table.get(seg[i], seg[i]))
            i += 1
    return apply_tone_sandhi(sylls, seg)

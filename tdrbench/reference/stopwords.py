# Frozen copy of the stopword lists the port embeds
# (tdr_torch/text/stopwords.py), for the reference's text layer.
"""Embedded multilingual stopword registry.

The reference pulls stopwords from NLTK data files plus a hand-rolled Korean
list (`ko_ww_stop_words`) — bm25_ranking.ipynb:~30-37 (`load_stopwords`),
cosine_similarity_bm25_reranking.py:24-35, final_implementation.py:40-47.
This environment has no NLTK data downloads, and a production framework
shouldn't depend on runtime downloads anyway, so the lists are embedded.
They cover the same 7 languages (en fr de es it ar ko) with standard
function-word inventories.

Two access patterns, mirroring the reference:
  * ``stopwords_for(lang)`` — per-language set (v2 pipelines,
    cosine_similarity_bm25_reranking.py:24-35).
  * ``stopword_union(langs)`` — union set across languages (the winning
    pipeline filters against a 5-language union, bm25_ranking.ipynb:~30-37).
"""

from __future__ import annotations

from functools import lru_cache
from typing import FrozenSet, Iterable

EN = """
a about above after again against all am an and any are aren't as at be because
been before being below between both but by can can't cannot could couldn't did
didn't do does doesn't doing don't down during each few for from further had
hadn't has hasn't have haven't having he he'd he'll he's her here here's hers
herself him himself his how how's i i'd i'll i'm i've if in into is isn't it
it's its itself let's me more most mustn't my myself no nor not of off on once
only or other ought our ours ourselves out over own same shan't she she'd
she'll she's should shouldn't so some such than that that's the their theirs
them themselves then there there's these they they'd they'll they're they've
this those through to too under until up very was wasn't we we'd we'll we're
we've were weren't what what's when when's where where's which while who who's
whom why why's will with won't would wouldn't you you'd you'll you're you've
your yours yourself yourselves
""".split()

FR = """
au aux avec ce ces cet cette dans de des du elle elles en et eux il ils je j'ai
la le les leur leurs lui ma mais me même mes moi mon ne nos notre nous on ont
ou où par pas pour qu que qui sa se ses son sur ta te tes toi ton tu un une vos
votre vous y été être eu eue eues eus suis es est sommes êtes sont serai seras
sera serons serez seront serais serait serions seriez seraient étais était
étions étiez étaient fus fut fûmes fûtes furent sois soit soyons soyez soient
fusse fusses fût ayant ayons ayez aient avais avait avions aviez avaient aurai
auras aura aurons aurez auront aurais aurait aurions auriez auraient ai as a
avons avez si plus comme tout tous toute toutes aussi autre autres sans sous
entre donc alors après avant bien cela celui celle ceux celles chez contre
encore ici leur quand très
""".split()

DE = """
aber alle allem allen aller alles als also am an ander andere anderem anderen
anderer anderes anderm andern anderr anders auch auf aus bei bin bis bist da
damit dann das daß dass dasselbe dazu dein deine deinem deinen deiner deines
dem demselben den denn denselben der derer derselbe derselben des desselben
dessen dich die dies diese dieselbe dieselben diesem diesen dieser dieses dir
doch dort du durch ein eine einem einen einer eines einig einige einigem
einigen einiger einiges einmal er es etwas euch euer eure eurem euren eurer
eures für gegen gewesen hab habe haben hat hatte hatten hier hin hinter ich
ihm ihn ihnen ihr ihre ihrem ihren ihrer ihres im in indem ins ist jede jedem
jeden jeder jedes jene jenem jenen jener jenes jetzt kann kein keine keinem
keinen keiner keines können könnte machen man manche manchem manchen mancher
manches mein meine meinem meinen meiner meines mich mir mit muss musste nach
nicht nichts noch nun nur ob oder ohne sehr sein seine seinem seinen seiner
seines selbst sich sie sind so solche solchem solchen solcher solches soll
sollte sondern sonst über um und uns unsere unserem unseren unser unseres
unter viel vom von vor während war waren warst was weg weil weiter welche
welchem welchen welcher welches wenn werde werden wie wieder will wir wird
wirst wo wollen wollte würde würden zu zum zur zwar zwischen
""".split()

ES = """
a al algo algunas algunos ante antes como con contra cual cuando de del desde
donde durante e el ella ellas ellos en entre era erais eran eras eres es esa
esas ese eso esos esta estaba estabais estaban estabas estad estada estadas
estado estados estamos estando estar estaremos estará estarán estarás estaré
estaréis estaría estaríais estaríamos estarían estarías estas este estemos
esto estos estoy estuve estuviera estuvierais estuvieran estuvieras
estuvieron estuviese estuvieseis estuviesen estuvieses estuvimos estuviste
estuvisteis estuvo está estábamos estáis están estás esté estéis estén estés
fue fuera fuerais fueran fueras fueron fuese fueseis fuesen fueses fui fuimos
fuiste fuisteis ha habida habidas habido habidos habiendo habremos habrá
habrán habrás habré habréis habría habríais habríamos habrían habrías habéis
había habíais habíamos habían habías han has hasta hay haya hayamos hayan
hayas hayáis he hemos hube hubiera hubierais hubieran hubieras hubieron
hubiese hubieseis hubiesen hubieses hubimos hubiste hubisteis hubo la las le
les lo los me mi mis mucho muchos muy más mí mía mías mío míos nada ni no nos
nosotras nosotros nuestra nuestras nuestro nuestros o os otra otras otro otros
para pero poco por porque que quien quienes qué se sea seamos sean seas seremos
será serán serás seré seréis sería seríais seríamos serían serías seáis sido
siendo sin sobre sois somos son soy su sus suya suyas suyo suyos sí también
tanto te tendremos tendrá tendrán tendrás tendré tendréis tendría tendríais
tendríamos tendrían tendrías tened tenemos tenga tengamos tengan tengas tengo
tengáis tenida tenidas tenido tenidos teniendo tenéis tenía teníais teníamos
tenían tenías ti tiene tienen tienes todo todos tu tus tuve tuviera tuvierais
tuvieran tuvieras tuvieron tuviese tuvieseis tuviesen tuvieses tuvimos tuviste
tuvisteis tuvo tuya tuyas tuyo tuyos tú un una uno unos vosotras vosotros
vuestra vuestras vuestro vuestros y ya yo él éramos
""".split()

IT = """
a abbia abbiamo abbiano abbiate ad agli ai al all alla alle allo anche avemmo
avendo avesse avessero avessi avessimo aveste avesti avete aveva avevamo
avevano avevate avevi avevo avrai avranno avrebbe avrebbero avrei avremmo
avremo avreste avresti avrete avrà avrò avuta avute avuti avuto c che chi ci
coi col come con contro cui da dagli dai dal dall dalla dalle dallo degli dei
del dell della delle dello di dov dove e ebbe ebbero ebbi ed era erano eravamo
eravate eri ero essendo faccia facciamo facciano facciate faccio facemmo
facendo facesse facessero facessi facessimo faceste facesti faceva facevamo
facevano facevate facevi facevo fai fanno farai faranno farebbe farebbero
farei faremmo faremo fareste faresti farete farà farò fece fecero feci fosse
fossero fossi fossimo foste fosti fu fui fummo furono gli ha hai hanno ho i il
in io l la le lei li lo loro lui ma mi mia mie miei mio ne negli nei nel nell
nella nelle nello noi non nostra nostre nostri nostro o per perché più quale
quanta quante quanti quanto quella quelle quelli quello questa queste questi
questo qui quindi sarai saranno sarebbe sarebbero sarei saremmo saremo sareste
saresti sarete sarà sarò se sei si sia siamo siano siate siete sono sta stai
stando stanno starai staranno starebbe starebbero starei staremmo staremo
stareste staresti starete starà starò stava stavamo stavano stavate stavi
stavo stemmo stesse stessero stessi stessimo steste stesti stette stettero
stetti stia stiamo stiano stiate sto su sua sue sugli sui sul sull sulla sulle
sullo suo suoi ti tra tu tua tue tuo tuoi tutti tutto un una uno vi voi vostra
vostre vostri vostro è
""".split()

AR = """
إذ إذا إذما إذن أف أقل أكثر ألا إلا التي الذي الذين اللاتي اللائي اللتان
اللتيا اللتين اللذان اللذين اللواتي إلى إليك إليكم إليكما إليكن أم أما إما أن
إن إنا أنا أنت أنتم أنتما أنتن إنما إنه أنى أنّى آه آها أو أولاء أولئك أوه آي
أي أيها إي أين أينما إيه بخ بس بعد بعض بك بكم بكما بكن بل بلى بما بماذا بمن
بنا به بها بهم بهما بهن بي بين بيد تلك تلكم تلكما ته تي تين تينك ثم ثمة حاشا
حبذا حتى حيث حيثما حين خلا دون ذا ذات ذاك ذان ذانك ذلك ذلكم ذلكما ذلكن ذه ذو
ذوا ذواتا ذواتي ذي ذين ذينك سوف سوى شتان عدا عسى عل على عليك عليه عما عن عند
غير فإذا فإن فلا فمن في فيم فيما فيه فيها قد كأن كأنما كأي كأين كذا كذلك كل
كلا كلاهما كلتا كلما كليكما كليهما كم كما كي كيت كيف كيفما لا لاسيما لدى لست
لستم لستما لستن لسن لسنا لعل لك لكم لكما لكن لكنما لكي لكيلا لم لما لن لنا له
لها لهم لهما لهن لو لولا لوما لي لئن ليت ليس ليسا ليست ليستا ليسوا ما ماذا
متى مذ مع مما ممن من منه منها مه مهما نحن نحو نعم ها هاتان هاته هاتي هاتين
هاك هاهنا هذا هذان هذه هذي هذين هكذا هل هلا هم هما هن هنا هناك هنالك هو هؤلاء
هي هيا هيت هيهات والذي والذين وإذ وإذا وإن ولا ولكن ولو وما ومن وهو يا
""".split()

# Korean: the reference uses a hand-rolled `ko_ww_stop_words` list of common
# particles, pronouns and light verbs (cosine_similarity_bm25_reranking.py:24-35).
KO = """
이 그 저 것 수 등 들 및 의 가 에 를 은 는 좀 잘 걍 과 도 으로 로 에게 뿐 다
만 께 에서 부터 까지 이다 하다 있다 없다 되다 같다 보다 주다 받다 말다 년 월
일 때 곳 중 안 밖 위 아래 앞 뒤 옆 번 개 명 살 원 분 초 시 또 또한 그리고
그러나 하지만 그래서 그러면 그런데 즉 한 두 세 네 다섯 여섯 일곱 여덟 아홉
열 아 휴 아이구 아이쿠 아이고 어 나 우리 저희 따라 의해 을 에게서 그냥 댁
매 매번 무엇 무슨 어느 몇 얼마 여러 왜 어떻게 어디 누구 언제 거의 매우 아주
너무 정말 진짜 모든 어떤 다른 이런 그런 저런 여기 거기 저기 지금 오늘 내일
어제 요즘 항상 자주 가끔 이미 아직 벌써 곧 바로 함께 서로 스스로 혼자 대해
대한 위해 위한 통해 통한 관한 관해 보이 않 없 합니다 입니다 있습니다 했다
한다 하는 하고 하며 하면 해서 하여 되어 된 될 되는
""".split()

KO_STOPWORDS = frozenset(KO)

_REGISTRY = {
    "en": frozenset(EN),
    "fr": frozenset(FR),
    "de": frozenset(DE),
    "es": frozenset(ES),
    "it": frozenset(IT),
    "ar": frozenset(AR),
    "ko": KO_STOPWORDS,
}


def stopwords_for(lang: str) -> FrozenSet[str]:
    """Per-language stopword set; unknown languages get the English set
    (matching the reference's try/except-fallback, final_implementation.py:43-46)."""
    return _REGISTRY.get(lang, _REGISTRY["en"])


@lru_cache(maxsize=8)
def _union(langs: tuple) -> FrozenSet[str]:
    out = set()
    for l in langs:
        out |= stopwords_for(l)
    return frozenset(out)


def stopword_union(langs: Iterable[str] = ("en", "fr", "de", "es", "it")) -> FrozenSet[str]:
    """Union stopword set across languages — the winning pipeline filters all
    latin-script languages against one union set (bm25_ranking.ipynb:~30-37)."""
    return _union(tuple(sorted(langs)))

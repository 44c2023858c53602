"""Frozen copy of the TPC-H word lists and enumerations (spec 4.2.2.13,
4.2.3) that the benchmark's table generator and reference read.

Copied from ``presto_tpu_torch/tpch/words.py``; the benchmark never
imports the program for its data or its reference.
"""
from __future__ import annotations

# --- fixed reference tables (spec 4.2.3: region/nation contents) ---

REGIONS = [
    # (regionkey, name)
    (0, "AFRICA"),
    (1, "AMERICA"),
    (2, "ASIA"),
    (3, "EUROPE"),
    (4, "MIDDLE EAST"),
]

NATIONS = [
    # (nationkey, name, regionkey)
    (0, "ALGERIA", 0),
    (1, "ARGENTINA", 1),
    (2, "BRAZIL", 1),
    (3, "CANADA", 1),
    (4, "EGYPT", 4),
    (5, "ETHIOPIA", 0),
    (6, "FRANCE", 3),
    (7, "GERMANY", 3),
    (8, "INDIA", 2),
    (9, "INDONESIA", 2),
    (10, "IRAN", 4),
    (11, "IRAQ", 4),
    (12, "JAPAN", 2),
    (13, "JORDAN", 4),
    (14, "KENYA", 0),
    (15, "MOROCCO", 0),
    (16, "MOZAMBIQUE", 0),
    (17, "PERU", 1),
    (18, "CHINA", 2),
    (19, "ROMANIA", 3),
    (20, "SAUDI ARABIA", 4),
    (21, "VIETNAM", 2),
    (22, "RUSSIA", 3),
    (23, "UNITED KINGDOM", 3),
    (24, "UNITED STATES", 1),
]

# --- enumerations drawn uniformly (spec 4.2.2.13) ---

MARKET_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]

ORDER_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]

SHIP_INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]

SHIP_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]

# P_TYPE = syllable1 + " " + syllable2 + " " + syllable3  (150 combos)
TYPE_SYLLABLE_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYLLABLE_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYLLABLE_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]

PART_TYPES = [
    f"{a} {b} {c}"
    for a in TYPE_SYLLABLE_1
    for b in TYPE_SYLLABLE_2
    for c in TYPE_SYLLABLE_3
]

# P_CONTAINER = container1 + " " + container2  (40 combos)
CONTAINER_SYLLABLE_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_SYLLABLE_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

PART_CONTAINERS = [
    f"{a} {b}" for a in CONTAINER_SYLLABLE_1 for b in CONTAINER_SYLLABLE_2
]

# P_NAME: 5 distinct words chosen from 92 colors (spec 4.2.2.13 "P_NAME
# generated by concatenating five unique randomly selected colors").
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic", "midnight",
    "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange", "orchid",
    "pale", "papaya", "peach", "peru", "pink", "plum", "powder", "puff",
    "purple", "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy",
    "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring", "steel",
    "tan", "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
assert len(COLORS) == 92

# --- free-text grammar (spec 4.2.2.10) ---
# text = sentence+ ; sentence = np vp term | np vp prep np term
#      | np vp np term | np prep vp np term | np prep vp prep np term
# np = noun | adj noun | adj ", " adj noun | article adj noun
# vp = verb | aux verb | verb adverb | aux verb adverb
# Word lists are spec-sized; "special"/"requests" and friends are included so
# query predicates (Q13 '%special%requests%') see natural-occurrence matches.

NOUNS = [
    "packages", "requests", "accounts", "deposits", "foxes", "ideas", "theodolites",
    "pinto beans", "instructions", "dependencies", "excuses", "platelets", "asymptotes",
    "courts", "dolphins", "multipliers", "sauternes", "warthogs", "frets", "dinos",
    "attainments", "somas", "Tiresias", "patterns", "forges", "braids", "hockey players",
    "frays", "warhorses", "dugouts", "notornis", "epitaphs", "pearls", "tithes",
    "waters", "orbits", "gifts", "sheaves", "depths", "sentiments", "decoys",
    "realms", "pains", "grouches", "escapades", "hockey",
]

VERBS = [
    "sleep", "wake", "are", "cajole", "haggle", "nag", "use", "boost", "affix",
    "detect", "integrate", "maintain", "nod", "was", "lose", "sublate", "solve",
    "thrash", "promise", "engage", "grow", "wade", "breach", "eat", "print",
    "x-ray", "breathe", "mold", "serve", "run", "dazzle", "snooze", "doze",
    "unwind", "kindle", "play", "hang", "believe", "doubt",
]

ADJECTIVES = [
    "special", "pending", "unusual", "express", "furious", "sly", "careful",
    "blithe", "quick", "fluffy", "slow", "quiet", "ruthless", "thin", "close",
    "dogged", "daring", "brave", "stealthy", "permanent", "enticing", "idle",
    "busy", "regular", "final", "ironic", "even", "bold", "silent",
]

ADVERBS = [
    "sometimes", "always", "never", "furiously", "slyly", "carefully", "blithely",
    "quickly", "fluffily", "slowly", "quietly", "ruthlessly", "thinly", "closely",
    "doggedly", "daringly", "bravely", "stealthily", "permanently", "enticingly",
    "idly", "busily", "regularly", "finally", "ironically", "evenly", "boldly",
    "silently", "express", "fully", "according to",
]

PREPOSITIONS = [
    "about", "above", "according to", "across", "after", "against", "along",
    "alongside of", "among", "around", "at", "atop", "before", "behind",
    "beneath", "beside", "besides", "between", "beyond", "by", "despite",
    "during", "except", "for", "from", "in place of", "inside", "instead of",
    "into", "near", "of", "on", "outside", "over", "past", "since", "through",
    "throughout", "to", "toward", "under", "until", "up", "upon", "without",
    "with", "within",
]

AUXILIARIES = [
    "do", "may", "might", "shall", "will", "would", "can", "could", "should",
    "ought to", "must", "will have to", "shall have to", "could have to",
    "should have to", "must have to", "need to", "try to",
]

TERMINATORS = [".", ";", ":", "?", "!", "--"]

ARTICLES = ["the", "a", "an"]

# --- date bookkeeping (spec 4.2.2.12, 4.2.3) ---
# dbgen represents dates as indices into [1992-01-01 .. 1998-12-31].
import datetime as _dt

START_DATE = _dt.date(1992, 1, 1)
CURRENT_DATE = _dt.date(1995, 6, 17)
END_DATE = _dt.date(1998, 12, 31)

EPOCH = _dt.date(1970, 1, 1)
START_DAYS = (START_DATE - EPOCH).days        # days-since-epoch of 1992-01-01
CURRENT_DAYS = (CURRENT_DATE - EPOCH).days
TOTAL_DATES = (END_DATE - START_DATE).days + 1  # 2557

# orderdate range leaves room for ship (<=121) + receipt (<=30) offsets
ORDER_DATE_MAX_OFFSET = TOTAL_DATES - 151 - 1   # inclusive offset from START_DATE

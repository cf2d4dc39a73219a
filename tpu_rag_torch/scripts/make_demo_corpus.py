"""Generate the bundled demo corpus (examples/docs/): ~250 deterministic
fantasy-lore documents (~1K chunks after sectioning) across the namespaces
and canonicality tiers the reference's bundled gamefantasy collection uses
(reference vector_store/ ships a prebuilt store; BASELINE.md config #1).

Deterministic (seeded): re-running reproduces byte-identical JSON, so the
checked-in corpus and the checked-in prebuilt store stay in sync.
Port of scripts/make_demo_corpus.py: the same documents, byte for byte.

  python -m tpu_rag_torch.scripts.make_demo_corpus --out examples/docs
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path

REGIONS = [
    ("Silver Cliff", "月之神殿", "lore"), ("Ember Vale", "餘燼谷", "lore"),
    ("Mistwood", "霧林", "lore"), ("Ashen Steppe", "灰原", "world"),
    ("Harbor of Bells", "鐘鳴港", "world"), ("Glass Desert", "琉璃沙漠", "world"),
    ("Iron Pass", "鐵隘口", "world"), ("Moon Lake", "月湖", "lore"),
    ("Dragon Spine", "龍脊山", "lore"), ("Salt Marsh", "鹽澤", "trade"),
]

SUBJECTS = [
    "temple", "clan", "caravan", "festival", "mine", "lighthouse", "archive",
    "garrison", "orchard", "shipyard", "observatory", "foundry", "bazaar",
    "aqueduct", "monastery", "warren", "library", "arena", "granary",
    "menagerie", "workshop", "sanctum", "bridge", "catacomb", "windmill",
]

TRAITS = [
    "carved from blue basalt", "older than the dynasty records",
    "guarded by sworn sisters", "lit by phosphor lanterns",
    "famous for its bell-metal", "half-sunk after the flood year",
    "rebuilt three times", "aligned with the solstice sunrise",
    "claimed by two rival clans", "taxed by the harbor league",
    "haunted by a patient ghost", "renowned for silk dyes",
    "powered by tide wheels", "sealed since the ash winter",
]

EVENTS = [
    "the Ember Accord was signed", "the first dragon census was taken",
    "the salt tariff riots began", "the twin comets crossed",
    "the deep vein collapsed", "the chorus of gulls fell silent",
    "the moon tide reached the third stair", "the archive fire was contained",
]

ROLES = [
    "keeper", "factor", "warden", "cartographer", "chronicler", "assayer",
    "tidecaller", "quartermaster", "lampwright", "beastmaster",
]

NAMES = [
    "Aldea", "Brann", "Caske", "Dorun", "Eilif", "Ferrow", "Gilda", "Hesk",
    "Ilvan", "Joss", "Kerrin", "Lumo", "Mirel", "Noor", "Oster", "Pell",
]


def make_doc(rng: random.Random, i: int) -> dict:
    region, region_zh, ns = REGIONS[i % len(REGIONS)]
    subject = SUBJECTS[(i * 7) % len(SUBJECTS)]
    title = f"{region} {subject.title()}"
    trait = rng.choice(TRAITS)
    trait2 = rng.choice(TRAITS)
    event = rng.choice(EVENTS)
    role = rng.choice(ROLES)
    name = rng.choice(NAMES)
    name2 = rng.choice(NAMES)
    year = 300 + rng.randrange(500)
    count = 3 + rng.randrange(40)
    canonicality = rng.choice(["canon", "canon", "canon", "draft", "meta"])
    summary = (f"The {subject} of {region} ({region_zh}) is {trait}. "
               f"It entered the registers in year {year}, when {event}.")
    # `body` is a dict of sections — the chunker emits one chunk per key
    # plus the ::summary chunk (tpu_rag_torch/ingest/chunker.py)
    body = {
        "history": (f"Founded in year {year}, the {region} {subject} is "
                    f"{trait}. Chroniclers note that {event} within a season "
                    f"of its founding, and the {role} {name} kept the first "
                    f"ledger. Its stone is {trait2}."),
        "operations": (f"Today the {subject} employs {count} hands under "
                       f"{role} {name2}. Trade flows through {region} toward "
                       f"the {REGIONS[(i + 3) % len(REGIONS)][0]}, carrying "
                       f"{rng.choice(['salt', 'silk', 'bell-metal', 'dye', 'grain', 'lantern oil'])} "
                       f"and news of the {SUBJECTS[(i * 5 + 2) % len(SUBJECTS)]}."),
        "disputes": (f"A standing dispute with the "
                     f"{REGIONS[(i + 5) % len(REGIONS)][0]} "
                     f"{SUBJECTS[(i * 3 + 1) % len(SUBJECTS)]} dates to year "
                     f"{year + rng.randrange(40)}; the {role}s meet at the "
                     f"{rng.choice(['equinox', 'solstice', 'moon tide'])} to "
                     f"renew the truce. {rng.choice(TRAITS).capitalize()}."),
    }
    return {
        "id": f"demo-{i:04d}",
        "namespace": ns,
        "canonicality": canonicality,
        "title": title,
        "title_zh": f"{region_zh}{subject}",
        "summary": summary,
        "body": body,
        "updated_ts": 1700000000 + i * 86400,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="examples/docs")
    ap.add_argument("--docs", type=int, default=250)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    rng = random.Random(args.seed)
    out = Path(args.out)
    for i in range(args.docs):
        doc = make_doc(rng, i)
        sub = out / doc["namespace"]
        sub.mkdir(parents=True, exist_ok=True)
        fp = sub / f"{doc['id']}.json"
        fp.write_text(json.dumps(doc, ensure_ascii=False, indent=1) + "\n",
                      encoding="utf-8")
    print(f"wrote {args.docs} docs under {out}")


if __name__ == "__main__":
    main()

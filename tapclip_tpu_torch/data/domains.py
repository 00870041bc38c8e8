"""Benchmark dataset registries: OfficeHome and DomainNet.

Counterpart of ``tapclip_tpu/data/domains.py``.  Both datasets are
ImageFolder-per-domain trees (``root/Domain/ClassName/img.jpg``), so the
generic loader covers them; these registries give the canonical domain
lists, the reference's class subsets and the class-discovery helpers.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

OFFICEHOME_DOMAINS = ["Real World", "Art", "Clipart", "Product"]
# The reference's few-shot class subsets:
OFFICEHOME_TRAIN_CLASSES = ["Backpack", "Alarm_Clock", "Laptop", "Pen", "Mug"]
OFFICEHOME_SEEN_CLASSES = ["Backpack", "Alarm_Clock", "Laptop", "Pen"]
OFFICEHOME_UNSEEN_CLASSES = ["Clipboards"]

DOMAINNET_DOMAINS = ["clipart", "infograph", "painting", "quickdraw", "real", "sketch"]
DOMAINNET_NUM_CLASSES = 345

DATASETS: Dict[str, Dict] = {
    "officehome": {
        "domains": OFFICEHOME_DOMAINS,
        "default_source": "Real World",
        "train_classes": OFFICEHOME_TRAIN_CLASSES,
    },
    "domainnet": {
        "domains": DOMAINNET_DOMAINS,
        "default_source": "real",
        "train_classes": None,  # discovered from the tree (345 classes)
    },
}


def discover_classes(domain_root: str, domain: str) -> List[str]:
    """All class folder names for a domain, sorted (ImageFolder order)."""
    d = os.path.join(domain_root, domain)
    return sorted(name for name in os.listdir(d) if os.path.isdir(os.path.join(d, name)))


def common_classes(domain_root: str, domains: Sequence[str]) -> List[str]:
    """Classes present in every listed domain (safe transfer-matrix set)."""
    sets = [set(discover_classes(domain_root, d)) for d in domains]
    return sorted(set.intersection(*sets)) if sets else []

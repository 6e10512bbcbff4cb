"""50salads L2 -> L1 activity hierarchy.

The port's own copy of ``r3d_tpu/data/salads50.py`` (reference
data/basedataset_proposed_50salads.py:10-66): the proposed-50salads path
trains on L1 activity labels derived from the fine L2 labels through the
ACTION_MAPPING table, and the L2 sequence rides along as the query stream.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

ACTION_MAPPING: Dict[str, List[str]] = {
    "cut_and_mix_ingredients": [
        "peel_cucumber", "cut_cucumber", "place_cucumber_into_bowl",
        "cut_tomato", "place_tomato_into_bowl", "cut_cheese",
        "place_cheese_into_bowl", "cut_lettuce", "place_lettuce_into_bowl",
        "mix_ingredients",
    ],
    "prepare_dressing": [
        "add_oil", "add_vinegar", "add_salt", "add_pepper", "mix_dressing",
    ],
    "serve_salad": ["serve_salad_onto_plate", "add_dressing"],
    "action_end": ["action_end"],
    "action_start": ["action_start"],
}


def l2_name_to_l1(l2_name: str) -> str:
    """Match an L2 label (possibly with _prep/_core/_post suffixes) to its L1
    activity by substring, as change_query_dict_2_action_dict does."""
    for l1, l2_list in ACTION_MAPPING.items():
        for l2 in l2_list:
            if l2 in l2_name:
                return l1
    return l2_name  # unmapped labels pass through


def relabel_sequence(l2_labels: Sequence[str]) -> List[str]:
    return [l2_name_to_l1(l) for l in l2_labels]


def l1_query_list(query_dict: Dict[str, int]) -> List[str]:
    """Per-L2-entry list of L1 activities in query_dict order
    (change_query_dict_2_action_dict:44-66 output)."""
    out: List[str] = []
    for q in query_dict:
        for l1, l2_list in ACTION_MAPPING.items():
            for l2 in l2_list:
                if l2 in q:
                    out.append(l1)
    return out

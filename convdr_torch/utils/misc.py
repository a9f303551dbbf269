"""Small utility parity with the reference's utils/util.py leftovers.

The counterpart of ``convdr_tpu/utils/misc.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple


def convert_to_string_id(result_dict: Dict) -> Dict[str, Dict[str, Any]]:
    """Nested dict keys -> strings (pytrec_eval interop, util.py:219-230)."""
    return {
        str(k): {str(inner_k): inner_v for inner_k, inner_v in v.items()}
        for k, v in result_dict.items()
    }


def get_checkpoint_no(checkpoint_path: str) -> int:
    """Last integer in a checkpoint path (util.py:292-293)."""
    return int(re.findall(r"\d+", checkpoint_path)[-1])


def get_latest_ann_data(
    ann_data_path: str,
) -> Tuple[int, Optional[str], Optional[dict]]:
    """Newest ``ann_ndcg_{n}`` metadata + its training-data path
    (util.py:296-313); (-1, None, None) when absent."""
    prefix = "ann_ndcg_"
    if not os.path.exists(ann_data_path):
        return -1, None, None
    nos = []
    for name in os.listdir(ann_data_path):
        if name.startswith(prefix):
            try:
                nos.append(int(name[len(prefix):]))
            except ValueError:
                continue
    if not nos:
        return -1, None, None
    data_no = max(nos)
    with open(os.path.join(ann_data_path, f"{prefix}{data_no}")) as f:
        ndcg_json = json.load(f)
    return (
        data_no,
        os.path.join(ann_data_path, f"ann_training_data_{data_no}"),
        ndcg_json,
    )


@dataclasses.dataclass
class InputFeaturesPair:
    """ANCE-heritage paired-feature container (util.py:35-76)."""

    input_ids_a: List[int]
    attention_mask_a: Optional[List[int]] = None
    token_type_ids_a: Optional[List[int]] = None
    input_ids_b: Optional[List[int]] = None
    attention_mask_b: Optional[List[int]] = None
    token_type_ids_b: Optional[List[int]] = None
    label: Optional[int] = None

    def to_json_string(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2) + "\n"

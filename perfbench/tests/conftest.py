"""The benchmark's CPU tests: the harness on the tiny configurations, the
counts against hand counts, the manifest's rules.  Tests marked ``cuda``
need the card and skip without it."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

LLMSEG_TINY = {
    "llm": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
            "rope_theta": 1000000.0, "rms_norm_eps": 1e-05, "vocab_size": 200,
            "tie_word_embeddings": False, "hidden_act": "silu"},
    "added_tokens": 4, "seg_token_id": 200, "max_seq_len": 64,
    "vision": {"image_size": 28, "patch_size": 14, "hidden_size": 32, "num_hidden_layers": 2,
               "num_attention_heads": 2, "intermediate_size": 128, "hidden_act": "quick_gelu",
               "layer_norm_eps": 1e-05, "select_layer": -2, "pre_layernorm": True,
               "layerscale": False},
    "dino": {"image_size": 56, "patch_size": 14, "hidden_size": 32, "num_hidden_layers": 2,
             "num_attention_heads": 2, "intermediate_size": 128, "hidden_act": "gelu_tanh",
             "layer_norm_eps": 1e-06, "pre_layernorm": False, "layerscale": True},
    "select": {"dim": 16, "num_heads": 2, "mlp_dim": 32, "depth": 2,
               "attention_downsample_rate": 2, "iou_head_hidden": 8, "embed_head_hidden": 32,
               "layer_norm_eps": 1e-05},
    "max_proposals": 8, "seg_grid": 16, "dtype": "float32",
}
PREDICT_TINY = {"images_per_batch": 2, "rows_per_image": 2, "text_len": 16, "pool_batches": 2,
                "warmup_calls": 1, "check_batches": 2}

SAM_TINY = {
    "encoder": {"image_size": 64, "patch_size": 16, "embed_dim": 32, "depth": 2, "num_heads": 2,
                "mlp_ratio": 4.0, "out_chans": 16, "window_size": 2, "global_attn_indexes": [1],
                "use_rel_pos": True, "layer_norm_eps": 1e-06, "mlp_act": "gelu_tanh",
                "rel_pos_init": "fan_in"},
    "prompt": {"embed_dim": 16, "image_embedding_size": 4, "input_image_size": 64,
               "mask_in_chans": 4},
    "decoder": {"transformer_dim": 16, "transformer_depth": 2, "transformer_mlp_dim": 32,
                "transformer_num_heads": 2, "attention_downsample_rate": 2,
                "num_multimask_outputs": 3, "iou_head_depth": 3, "iou_head_hidden_dim": 16,
                "layer_norm_eps": 1e-06, "tied_upscale": True},
    "pixel_mean": [123.675, 116.28, 103.53], "pixel_std": [58.395, 57.12, 57.375],
    "mask_threshold": 0.0, "dtype": "float32", "weights_seed": 0,
}
AMG_TINY = {"sizes": [[64, 48], [40, 64]], "image_seed": 0, "noise": 40, "discs": 2, "radius": [5, 20], "pool_images": 2, "warmup_images": 1,
            "check_images": 2,
            "amg": {"points_per_side": 4, "points_per_batch": 8, "pred_iou_thresh": -1e9,
                    "stability_score_thresh": -1.0, "stability_score_offset": 1.0,
                    "box_nms_thresh": 1.1, "crop_n_layers": 0, "min_mask_region_area": 0,
                    "max_masks": 6}}


def tiny_cell(name: str):
    """The manifest's cell ``name`` with the tiny configuration and traffic,
    the limits of its workload file kept."""
    from pbcore import manifest
    cell = manifest.load(name)
    entry = cell.work["entry"]
    cell.config = copy.deepcopy(LLMSEG_TINY if entry == "predict" else SAM_TINY)
    cell.work = dict(cell.work, traffic=copy.deepcopy(PREDICT_TINY if entry == "predict"
                                                      else AMG_TINY))
    return cell


@pytest.fixture
def predict_cell():
    return tiny_cell("llmseg_mistral7b.predict_b4")


@pytest.fixture
def amg_cell():
    return tiny_cell("sam_vit_h.amg_k50")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

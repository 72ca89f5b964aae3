"""Offline data-preparation toolkit (counterpart of deepim_tpu/toolkit/).

Each module is a runnable CLI (`python -m deepim_tpu_torch.toolkit.<name>
...`, with `--device`, default cuda) mirroring one stage of the reference
pipeline, with rendering done by the port's batched rasterizer on the card
(_common.BatchRenderer), images read by utils/imread.py and PNGs written by
utils/png.py:

* adapt_devkit         — LM6d_devkit/LM6d_0_rescale_models.py, LM6d_1_calc_extents.py,
                         LM6d_2a_adapt_images.py (BOP-format source -> devkit)
* gen_gt_observed      — LM6d_0_gen_gt_observed.py
* gen_rendered_pose    — LM6d_1_gen_rendered_pose.py
* gen_rendered         — LM6d_2_gen_rendered.py
* gen_posecnn_rendered — LM6d_3_gen_PoseCNN_pred_rendered.py
* syn_poses            — LM6d_ds_0_gen_observed_poses.py (+ ds check)
* stats                — lib/pair_matching/stat_se3.py, stat_depth.py
* gen_video            — gen_video_* family (the refinement videos)
"""

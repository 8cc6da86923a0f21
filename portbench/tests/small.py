"""A small configuration of any cell for the CPU tests: every shape cut so a
run takes seconds on the CPU; the code paths are the cell's own."""


def small(dtype: str = "bfloat16", int8: bool = False):
    def adjust(config: dict, traffic: dict) -> None:
        config["net"].update(canvas=[64, 96], anchor_scales=[1, 2, 4], pre_nms_top_n=64,
                             post_nms_top_n=16, rpn_min_size=4.0, fc_dim=64, mask_fc_dim=32,
                             num_classes=5, compute_dtype=dtype, int8=int8)
        config["post"].update(dets_per_class=4, max_per_image=8, vote_top_k=8)
        traffic.update(pool_requests=4, canvases_per_request=2, warmup_requests=1,
                       sample_requests=4, traced_requests=2, host_traced_requests=2,
                       short_side=48, max_side=90, photo_sizes=[[30, 40], [40, 40], [36, 60]])
    return adjust


SEED = 2**31 + 977  # beyond 32 signed bits, as the driver's seeds are

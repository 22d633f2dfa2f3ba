"""The POPCORN population-mapping model.

Counterpart of popcorn_tpu/nn/popcorn.py (reference model/popcorn.py):

  popdensemap = relu(head(unet(x))[..., 0]) * building_score  (occupancy)
  popcount    = sum over the admin region

with a dual-stream UNet feature extractor (trainable in training), a
second frozen dual-stream UNet as on-the-fly building extractor, and the
4-layer 1x1 head. The port has one engine, plain NHWC: the JAX package's
packed and wide engines (nn/packed.py, nn/wide.py) are TPU lane layouts
of the same math. As in the JAX package, the sparsity mask of training
only restricts the scale regulariser: the head runs densely, and every
pixel that can add to popcount lies in the mask.

``ModelConfig.layout`` selects the JAX package's engine
(popcorn_tpu/nn/popcorn.py::select_engine): every value it names,
``LAYOUTS``, runs here on the one NHWC engine with kernels A-C, so the
values give the same maps; another value raises (``check_config``), where
the JAX package falls through to its packed or plain engine.
``pallas_packed_head`` selects the JAX package's packed head kernel; here
the head is kernel C whenever ``fused_head`` is set, whatever its value.

Quantized eval (``cfg.quantize``, never in training) follows the JAX
package's gates: 'int8' runs the member UNets' blocks through the dynamic
int8 kernels on an unpadded input, and the building extractor too with
``pallas_stream=True``; 'int8s'/'w4a8' run both member streams in static
int8 when the caller passes the member's calibrated ``scales`` (the eval
fold, infer/sliding.py), an unpadded input and H % 4 == W % 4 == 0, and
float otherwise, as the JAX package's popcorn_forward does.

Compute dtype (``cfg.compute_dtype``, "float32" or "bfloat16", the JAX
package's rule): in bfloat16 the UNets (member and builder) and the
eval head compute in bf16 (nn/unet.py, nn/head.py), the training head in
float32 (as fused_head), and the maps, popcount and losses are float32.
The static int8 stream quantizes its float32 input and rounds only its
float features to bf16 (popcorn_tpu/nn/packed.py:482).

The head (``cfg.fused_head``, JAX's gate ``cfg.fused_head and
feats.shape[-1] == 16``, popcorn_tpu/nn/popcorn.py:627): fused, kernel C
(and D in training, nn/head.py); unfused, four 1x1 convs in the compute
dtype under autograd (nn/head.py::head_unfused), in training and in eval,
so a bf16 unfused head computes in bf16 where the fused training head
computes in float32, as in the JAX package. JAX's eval of an unpadded
patch takes its packed engine, whose unfused head is packed_head_apply,
the same four products in block-diagonal form (:599-613); on the port's
one plain engine the unfused route stands for both.

The feature extractor (``cfg.feature_extractor``): 'DDA', the dual-stream
UNet above, or a Prithvi-EO-2.0 encoder with its neck (nn/prithvi.py,
``-fe prithvi_eo2_300m``), whose parameters replace the tree's 'unet'
with 'encoder' and 'neck'. It runs each sample on its extent in the
bucket (``inputs['extent']``, the whole input where absent) and needs no
padding; the building extractor, the head, the occupancy product and the
sparsity mask are the same for both. It has no int8 path, no whole-frame
eval and no spatial training: ``check_config`` refuses them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import ModelConfig
from .head import head_apply, head_train, head_unfused
from . import prithvi
from .ops import add_padding, revert_padding
from .quant import calibrate_stream
from .unet import SAR_IN, building_logits, dual_stream_features, unet_stream_qs

Tree = Dict[str, Any]


def reorder_to_dda(x: torch.Tensor, *, s1: bool, s2: bool, nir: bool) -> torch.Tensor:
    """Reorder the assembled input [S2: R,G,B(,NIR)][S1: VV,VH] into DDA's
    6-channel order [VV, VH, B02(B), B03(G), B04(R), B08(NIR)]
    (model/popcorn.py:129-145: RGB is flipped to the BGR order the DDA
    checkpoint was trained on). Missing modalities are zero-filled."""
    b, h, w, _ = x.shape

    def zeros(c):
        return x.new_zeros((b, h, w, c))

    if s2:
        n_s2 = 4 if nir else 3
        bgr = torch.flip(x[..., :3], dims=(-1,))  # R,G,B -> B,G,R
        nir_c = x[..., 3:4] if nir else zeros(1)
        s1_c = x[..., n_s2 : n_s2 + 2] if s1 else zeros(2)
        return torch.cat([s1_c, bgr, nir_c], dim=-1)
    if s1:
        return torch.cat([x[..., :2], zeros(4)], dim=-1)
    raise ValueError("at least one of S1/S2 must be enabled")


QUANTIZE_MODES = ("int8", "int8s", "w4a8")
LAYOUTS = ("auto", "packed", "wide", "spatial", "plain")
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> Optional[torch.dtype]:
    """The blocks' compute dtype: None (float32) or torch.bfloat16 (the
    JAX package's ``dtype = jnp.bfloat16 if cfg.compute_dtype ==
    'bfloat16' else None``)."""
    return COMPUTE_DTYPES[cfg.compute_dtype]


def check_config(cfg: ModelConfig, *, spatial: bool = False, spatial_train: bool = False) -> None:
    """Raise for model options the port does not run, or that conflict;
    ``spatial`` and ``spatial_train`` are the run's whole-frame eval and
    spatial training."""
    fe = cfg.feature_extractor
    if fe != "DDA" and fe not in prithvi.PRESETS:
        raise ValueError(f"feature_extractor={fe!r}: 'DDA' or one of {tuple(prithvi.PRESETS)}")
    if fe in prithvi.PRESETS:
        if cfg.quantize:
            raise ValueError(f"--quantize {cfg.quantize} runs the UNet's int8 kernels; the "
                             f"{fe} member has no int8 path: drop --quantize or use -fe DDA")
        if spatial:
            raise ValueError(f"--spatial cuts frames into row blocks with the UNet's receptive "
                             f"field as context; the {fe} encoder attends over a whole sample: "
                             "drop --spatial")
        if spatial_train:
            raise ValueError(f"--spatial_train splits a crop's rows over ranks by the UNet's "
                             f"receptive field; the {fe} encoder attends over the whole crop: "
                             "drop --spatial_train")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: one of {tuple(COMPUTE_DTYPES)}")
    if cfg.layout not in LAYOUTS:
        raise ValueError(f"layout={cfg.layout!r}: one of {LAYOUTS}, which all run the "
                         "port's one NHWC engine")
    if cfg.quantize is not None and cfg.quantize not in QUANTIZE_MODES:
        raise ValueError(f"quantize={cfg.quantize!r}: one of {QUANTIZE_MODES} or None")
    if cfg.quantize and cfg.pallas_stream is False:
        # popcorn_tpu/nn/popcorn.py::use_pallas_stream
        raise ValueError(
            f"quantize={cfg.quantize!r} requires the fused UNet-block kernels; "
            "pallas_stream=False conflicts with it — drop one of the two"
        )


def quantize_int8(cfg: ModelConfig, train: bool = False) -> bool:
    """Dynamic int8 eval ('int8'): kernels G and H in the member UNets."""
    return not train and cfg.quantize == "int8"


def quantize_static_int8(cfg: ModelConfig, train: bool = False) -> bool:
    """Static int8 eval ('int8s', and 'w4a8' with int4-grid weights):
    kernels E and F with calibrated scales, in the eval fold."""
    return not train and cfg.quantize in ("int8s", "w4a8")


def weight_bits(cfg: ModelConfig) -> int:
    return 4 if cfg.quantize == "w4a8" else 8


def builder_quantized(cfg: ModelConfig, train: bool = False) -> bool:
    """Whether the building extractor runs the dynamic int8 kernels: only
    with 'int8' and ``pallas_stream=True``. The JAX package keeps the
    builder in float in every quantize mode unless that flag asks for its
    fused kernels (popcorn_tpu/nn/popcorn.py::builder_use_pallas, the
    ``quantized=quantize_int8(cfg) and bp`` of its callers)."""
    return quantize_int8(cfg, train) and cfg.pallas_stream is True


def fold_unpadded(cfg: ModelConfig, h: int, w: int) -> bool:
    """Whether the eval fold runs a member on the patch as it is, with no
    padding: the JAX package's packed fold, which it takes when both
    streams run and H and W are even (choose_pack_factor > 1,
    popcorn_tpu/infer/sliding.py:175-227). Elsewhere its plain fold pads
    by the reference's rule (``add_padding(force=False)``)."""
    return bool(cfg.s1 and cfg.s2) and h % 2 == 0 and w % 2 == 0


def calibrate_member_scales(params: Tree, consts: Tree, x: torch.Tensor, cfg: ModelConfig) -> Tree:
    """Static int8 scales of one member's two UNet streams from a
    calibration batch ``x`` (the unpadded normalized input, as the fold
    sees it): {'sar': ..., 'opt': ...}, each nn/quant.py::calibrate_stream's
    12 scales."""
    x6 = reorder_to_dda(x, s1=cfg.s1, s2=cfg.s2, nir=cfg.nir)
    return {
        "sar": calibrate_stream(params["unet"]["sar"], consts["unet_bn"]["sar"], x6[..., :SAR_IN]),
        "opt": calibrate_stream(params["unet"]["opt"], consts["unet_bn"]["opt"], x6[..., SAR_IN:]),
    }


@torch.no_grad()
def create_building_score(
    builder: Tree, x_input: torch.Tensor, *, s1: bool, s2: bool, nir: bool,
    quantize: bool = False, dtype=None,
) -> torch.Tensor:
    """On-the-fly built-up probability (model/popcorn.py:279-322):
    reflect-pad 14 px, the frozen building-extractor UNet in ``dtype``
    (dynamic int8 blocks with ``quantize``, see ``builder_quantized``),
    sigmoid in float32, unpad. Returns the (B, H, W) float32 score."""
    xp, pad = add_padding(x_input, force=True)
    x6 = reorder_to_dda(xp, s1=s1, s2=s2, nir=nir)
    logits = building_logits(builder["params"], builder["bn"], x6, s1=s1, s2=s2,
                             quantize=quantize, dtype=dtype)
    score = torch.sigmoid(logits.float())
    return revert_padding(score, pad)[..., 0]


def sparsity_mask(
    generator: torch.Generator,
    building_counts: Optional[torch.Tensor],
    admin_mask: torch.Tensor,
    census_idx: torch.Tensor,
    *,
    occupancy: bool,
    any_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    rows: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """The training sparsity mask (model/popcorn.py:361-377;
    popcorn_tpu/nn/popcorn.py::sparsity_mask).

    mask = (buildings > 0 [if occupancy]) AND (admin == census_idx), plus a
    random 60x60 row/column lattice (one draw shared across the batch, as
    in the reference) clipped to the admin region, falling back to the
    whole admin region when the batch's mask is empty. The lattice rows
    and columns are ``torch.randperm(n, generator=generator)[:60]``, drawn
    on the generator's device (the trainer's is on the CPU) and moved to
    the mask's; JAX's draw cannot be matched bit for bit, so tests inject
    its mask through ``popcorn_forward(mask=...)``. Under data parallelism
    ``any_fn`` turns this rank's "is the mask empty" into the global
    batch's (every rank draws the same lattice from the same generator
    state). ``rows`` = (hp, k0, k1): the inputs are rows [k0, k1) of crops
    of ``hp`` rows (a rank's block in spatial training); the lattice is
    drawn over ``hp`` rows, rows then columns, as on one device, and its
    rows [k0, k1) are kept, so the ranks' blocks together are the
    one-device mask of the same generator state."""
    admin_sel = admin_mask == census_idx[:, None, None]
    if building_counts is not None and building_counts.dim() == 4:
        building_counts = building_counts[..., 0]
    m = (building_counts > 0) & admin_sel if occupancy else admin_sel
    _, h, w = m.shape
    hp, k0, k1 = (h, 0, h) if rows is None else rows
    gdev = generator.device
    xi = torch.randperm(hp, generator=generator, device=gdev)[: min(60, hp)]
    yi = torch.randperm(w, generator=generator, device=gdev)[: min(60, w)]
    lat_rows = torch.zeros(hp, dtype=torch.bool, device=gdev)
    cols = torch.zeros(w, dtype=torch.bool, device=gdev)
    lat_rows[xi] = True
    cols[yi] = True
    lattice = (lat_rows[k0:k1, None] & cols[None, :]).to(m.device)
    m = (m | lattice[None]) & admin_sel
    nonempty = m.any() if any_fn is None else any_fn(m.any())
    return torch.where(nonempty, m, admin_sel)


@torch.no_grad()
def popcorn_predict(
    params: Tree, consts: Tree, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
    *, padding: Optional[bool] = True, scales: Optional[Tree] = None,
) -> Dict[str, Any]:
    """The eval forward without autograd: every UNet block and the
    channel-0 head through their kernels on the card."""
    return popcorn_forward(params, consts, inputs, cfg, padding=padding, scales=scales)


def popcorn_forward(
    params: Tree,
    consts: Tree,
    inputs: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    train: bool = False,
    padding: Optional[bool] = True,
    encoder_no_grad: bool = False,
    unet_no_grad: bool = False,
    sparse: bool = False,
    generator: Optional[torch.Generator] = None,
    mask: Optional[torch.Tensor] = None,
    scales: Optional[Tree] = None,
    mask_any: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    keep: Optional[Tuple[slice, slice]] = None,
) -> Dict[str, Any]:
    """Full POPCORN forward pass (model/popcorn.py:100-193).

    params: {'unet': dual-stream tree, 'head': {'l1'..'l4': {w,b}}}, or
            with a Prithvi extractor {'encoder', 'neck', 'head'}
    consts: {'unet_bn': BN constants, 'builder': {'params','bn'}}
            ('unet_bn' only with the UNet extractor)
    inputs: {'input': (B,H,W,C) normalized modality concat,
             optional 'building_counts': (B,H,W) or (B,H,W,1),
             optional 'admin_mask': (B,H,W), 'census_idx': (B,),
             optional 'extent': (B, 4) host ints (r0, r1, c0, c1), each
             sample's pixels in the bucket, which a Prithvi extractor
             reads (module docstring)}

    ``train`` differentiates the UNet blocks (except those frozen by the
    memory tiers ``encoder_no_grad`` / ``unet_no_grad``, which run their
    kernels without a gradient, nn/unet.py) and the head, whose training
    forward is kernel C with two channels and whose backward is kernel D
    (nn/head.py::head_train). Without ``train`` the whole model runs its
    kernels and the head emits channel 0 only: call it under no_grad
    (``popcorn_predict``), as the kernels refuse tensors that need a
    gradient. With ``cfg.fused_head`` False the head is
    nn/head.py::head_unfused in both (module docstring). ``padding``: True
    reflect-pads 14 px, False pads by the reference's rule
    (``add_padding(force=False)``), None runs the input as it is (the eval
    fold's choice, ``fold_unpadded``). ``sparse``
    draws the sparsity mask from ``generator`` unless a precomputed
    ``mask`` (B,H,W) bool is given. ``scales``: the
    member's static int8 scales (``calibrate_member_scales``), which the
    'int8s'/'w4a8' eval uses where it applies (module docstring).
    ``mask_any``: ``sparsity_mask``'s ``any_fn`` (data-parallel training).
    ``keep``: the (rows, columns) of the UNet's output that the head, the
    maps and the popcount take, and of the building score; 'admin_mask'
    and ``mask`` are given at that shape. Spatial training runs a rank's
    window and keeps its own rows (train/state.py), so no context row
    reaches the head or the loss.

    Returns {'popcount': (B,), 'popdensemap': (B,H,W), 'scale': (B,H,W)
    or None, 'scale_abs_mean': mean |scale| (over the mask when sparse) or
    None, 'building_counts', and 'sparsity_mask' when sparse}.
    """
    check_config(cfg)
    dtype = compute_dtype(cfg)
    x = inputs["input"]
    if "building_counts" not in inputs or cfg.sentinel_buildings:
        building_counts = create_building_score(
            consts["builder"], x, s1=cfg.s1, s2=cfg.s2, nir=cfg.nir,
            quantize=builder_quantized(cfg, train), dtype=dtype,
        )
    else:
        building_counts = inputs["building_counts"]
        if building_counts.dim() == 4:
            building_counts = building_counts[..., 0]
    if keep is not None:
        building_counts = building_counts[:, keep[0], keep[1]]

    if sparse and mask is None:
        if generator is None:
            raise ValueError("sparse=True requires a generator or a precomputed mask")
        mask = sparsity_mask(
            generator, building_counts, inputs["admin_mask"], inputs["census_idx"],
            occupancy=cfg.occupancy_model, any_fn=mask_any,
        )
    if not sparse:
        mask = None

    if cfg.feature_extractor in prithvi.PRESETS:
        x6 = reorder_to_dda(x, s1=cfg.s1, s2=cfg.s2, nir=cfg.nir)
        feats = prithvi.features(
            params, x6, inputs.get("extent"), prithvi.PRESETS[cfg.feature_extractor], dtype,
            encoder_no_grad=not train or encoder_no_grad,
            neck_no_grad=not train or unet_no_grad,
        )
        return _head_and_maps(params, feats, building_counts, inputs, cfg, train, dtype, mask,
                              keep)
    xp, pad = (x, (None,) * 4) if padding is None else add_padding(x, force=padding)
    x6 = reorder_to_dda(xp, s1=cfg.s1, s2=cfg.s2, nir=cfg.nir)
    # the JAX package quantizes only in its packed engine, which it takes
    # for an unpadded input (popcorn_tpu/nn/popcorn.py:557-562)
    unpadded = pad == (None, None, None, None)
    h, w = x6.shape[1], x6.shape[2]
    if (
        quantize_static_int8(cfg, train) and scales is not None and unpadded
        and cfg.s1 and cfg.s2 and h % 4 == 0 and w % 4 == 0
    ):
        wb = weight_bits(cfg)
        feats = torch.cat([
            unet_stream_qs(params["unet"]["sar"], consts["unet_bn"]["sar"], x6[..., :SAR_IN],
                           scales["sar"], wb, dtype),
            unet_stream_qs(params["unet"]["opt"], consts["unet_bn"]["opt"], x6[..., SAR_IN:],
                           scales["opt"], wb, dtype),
        ], dim=-1)
    else:
        trainable = train and not unet_no_grad
        feats = dual_stream_features(
            params["unet"], consts["unet_bn"], x6, s1=cfg.s1, s2=cfg.s2,
            train=trainable, encoder_stop_grad=encoder_no_grad,
            remat=cfg.remat_unet and trainable,
            quantize=quantize_int8(cfg, train) and unpadded, dtype=dtype,
        )
    feats = revert_padding(feats, pad)
    return _head_and_maps(params, feats, building_counts, inputs, cfg, train, dtype, mask, keep)


def _head_and_maps(params, feats, building_counts, inputs, cfg, train, dtype, mask, keep):
    """popcorn_forward after the feature extractor: the head on the
    (B, H, W, 16) features, the occupancy product and the sums."""
    if keep is not None:
        feats = feats[:, keep[0], keep[1]]
    feats = feats.contiguous()
    if not (cfg.fused_head and feats.shape[-1] == 16):  # the kernels are 16-channel only
        out = head_unfused(params["head"], feats, dtype)[..., 0].float()
    elif train:
        out = head_train(params["head"], feats)[..., 0]
    else:
        out = head_apply(params["head"], feats, n_out=1)[..., 0].float()

    if cfg.occupancy_model:
        scale = torch.relu(out)
        popdensemap = scale * building_counts.float()
    else:
        scale = None
        popdensemap = torch.relu(out)

    if "admin_mask" in inputs:
        sel = inputs["admin_mask"] == inputs["census_idx"][:, None, None]
        popcount = torch.sum(popdensemap * sel, dim=(1, 2))
    else:
        popcount = torch.sum(popdensemap, dim=(1, 2))
    if scale is None:
        scale_abs_mean = None
    elif mask is not None:
        # |scale| mean over the sparsity mask: the reference's mean over
        # scale[sparsity_mask]
        scale_abs_mean = torch.sum(torch.abs(scale) * mask) / torch.clamp(torch.sum(mask), min=1)
    else:
        scale_abs_mean = torch.mean(torch.abs(scale))
    result = {
        "popcount": popcount,
        "popdensemap": popdensemap,
        "scale": scale,
        "scale_abs_mean": scale_abs_mean,
        "building_counts": building_counts,
    }
    if mask is not None:
        result["sparsity_mask"] = mask
    return result

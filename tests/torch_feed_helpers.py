"""Batch comparison for the port's feed tests: a host feed's batch and a
device feed's batch are equal when the train step would see the same
tensors, i.e. after the host batch's upload (infer/sliding.py::_upload)."""

import numpy as np
import torch

from popcorn_tpu_torch.infer.sliding import _upload

CPU = torch.device("cpu")
IMAGE_KEYS = ("S2", "S1", "VIIRS", "building_counts", "building_segmentation", "admin_mask")


def uploaded(batch):
    """A batch as the train step sees it: the host feed's arrays through
    the upload, the device feed's tensors as they are."""
    out = dict(batch)
    for k in IMAGE_KEYS:
        if k in batch:
            out[k] = _upload(batch, CPU, (k,))[k]
    return out


def assert_batches_equal(host_batches, dev_batches):
    assert len(host_batches) == len(dev_batches) > 0
    for bh, bd in zip(host_batches, dev_batches):
        bh, bd = uploaded(bh), uploaded(bd)
        assert set(bh) == set(bd), (sorted(bh), sorted(bd))
        for k in bh:
            a, b = bh[k], bd[k]
            if isinstance(a, torch.Tensor):
                assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, (k, a.dtype, b)
                assert a.shape == b.shape, (k, a.shape, b.shape)
                assert torch.equal(a, b), k
            else:
                assert np.asarray(a).dtype == np.asarray(b).dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)


def assert_extent_holds_the_samples(batch):
    """Each sample's 'extent' (r0, r1, c0, c1) lies in the bucket and its
    admin mask is -1 (the padding) everywhere outside it."""
    adm = np.asarray(uploaded(batch)["admin_mask"])
    assert batch["extent"].dtype == torch.int64
    ext = batch["extent"].numpy()
    assert ext.shape == (adm.shape[0], 4)
    for a, (r0, r1, c0, c1) in zip(adm, ext):
        assert 0 <= r0 < r1 <= a.shape[0] and 0 <= c0 < c1 <= a.shape[1]
        outside = np.ones(a.shape, bool)
        outside[r0:r1, c0:c1] = False
        assert (a[outside] == -1).all()

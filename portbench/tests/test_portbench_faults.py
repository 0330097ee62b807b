"""``correct`` comes out false when the timed path is broken underneath
(each fault a cell can have), and for the control: the program's own
lower-precision path at the cells' limits."""

import pytest

from conftest import rehearse

FAULTS = {
    # A bin of every product row altered by a part in a thousand where
    # the product is written.
    ("tiny.0002", "bin_altered"): """
        import blit_torch.io.sigproc as sp
        _append = sp.FilWriter.append
        def append(self, slab):
            slab = slab.copy()
            slab[:, 0, 5] *= 1.001
            _append(self, slab)
        sp.FilWriter.append = append
    """,
    # Half of each integration's frames left out, the sum scaled from the rest.
    ("tiny.0002", "half_integration"): """
        import blit_torch.ops.channelize as ch
        def integrate(power, nint):
            shape = power.shape[:-2] + (power.shape[-2] // nint, nint, power.shape[-1])
            return 2 * power.reshape(shape)[..., :nint // 2, :].sum(dim=-2)
        ch.integrate = integrate
    """,
    # One block copied into its chunk slot from the block before it: a
    # few rows in the middle of the stream go wrong, the rest stay right.
    ("tiny.0002", "block_from_another_chunk"): """
        import blit_torch.stream.plane as plane
        _feed_one = plane.LiveRawStream._feed_one
        def feed_one(self, c, last):
            self.prev_data, data = getattr(self, "prev_data", c.data), c.data
            if c.seq == 5:
                c.data = self.prev_data
            self.prev_data = data
            return _feed_one(self, c, last)
        plane.LiveRawStream._feed_one = feed_one
    """,
    # One chunk's rows never reach the product.
    ("tiny.0002", "rows_left_out"): """
        import blit_torch.io.sigproc as sp
        _append = sp.FilWriter.append
        def append(self, slab):
            self.calls = getattr(self, "calls", 0) + 1
            if self.calls != 2:
                _append(self, slab)
        sp.FilWriter.append = append
    """,
}


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_fault_makes_correct_false(tree, workload, fault):
    rc, last, err = rehearse(tree, workload, fault=FAULTS[workload, fault])
    assert rc == 0, err
    assert last["correct"] is False
    assert last["failed"] > 0


def test_control_makes_correct_false(tree):
    rc, last, err = rehearse(tree, "tiny.0002", control=True)
    assert rc == 0, err
    assert last["correct"] is False

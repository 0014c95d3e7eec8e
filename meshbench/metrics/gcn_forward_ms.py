"""gcn_forward_ms: the model, device ms per train step from the joint
model's ``gcn`` mark (the two decodes done) to its ``forward`` mark: the
GCN's forward and the joint loss, a part of forward_ms. The median over the
window's epochs of each epoch's mean (the sub-phase ``gcn_forward`` of the
program's phase records, meshbench/phases.py). A program or a model
without the mark leaves no such sub-phase, and the reader returns None."""
import numpy as np

from meshbench.phases import window


def read(ctx):
    recs = window(ctx)
    per_epoch = [rec["sub_phases"]["gcn_forward"].mean()
                 for rec in (recs or {}).get("train", [])
                 if "gcn_forward" in rec.get("sub_phases", {})]
    return float(np.median(per_epoch)) if per_epoch else None

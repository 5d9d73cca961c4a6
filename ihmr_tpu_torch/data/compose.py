"""Multi-dataset composition (port of ihmr_tpu/data/compose.py).

One or more datasets behind a flat index map, in order; per-epoch
shuffling is delegated to each member.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


class ComposeDataset:
    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("ComposeDataset needs at least one dataset")
        self.datasets = list(datasets)
        for ds in self.datasets:
            if not getattr(ds, "data_list", None):
                ds.load_data()
        self._rebuild_index()

    def _rebuild_index(self):
        self.index_map: List = []
        for ds_id, ds in enumerate(self.datasets):
            self.index_map += [(ds_id, i) for i in range(len(ds))]

    def __len__(self):
        return len(self.index_map)

    def __getitem__(self, index: int) -> Dict:
        ds_id, local = self.index_map[index]
        return self.datasets[ds_id][local]

    getitem = __getitem__

    def shuffle_data(self):
        for ds in self.datasets:
            ds.shuffle_data()

    @property
    def num_add(self) -> int:
        return sum(getattr(ds, "num_add", 0) for ds in self.datasets)

    @property
    def data_list(self):
        out = []
        for ds in self.datasets:
            out += ds.data_list
        return out

    @property
    def name(self) -> str:
        return "+".join(getattr(ds, "name", "dataset") for ds in self.datasets)

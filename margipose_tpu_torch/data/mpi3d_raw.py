"""Loaders for raw (unprocessed) MPI-INF-3DHP test data
(reference: src/margipose/data/mpi_inf_3dhp/raw.py).

The port's copy of ``margipose_tpu/data/mpi3d_raw.py``.
"""

from __future__ import annotations

from os import path

import numpy as np


class RawMpiTestSeqDataset:
    def __init__(self, data_dir, seq_id, valid_only=True):
        import h5py

        self.data_dir = data_dir
        self.seq_id = seq_id
        self.annot_file = path.join(data_dir, seq_id, 'annot_data.mat')
        with h5py.File(self.annot_file, 'r') as annot:
            if valid_only:
                self.frame_indices = list(np.where(np.asarray(annot['valid_frame']).flatten())[0])
            else:
                self.frame_indices = list(range(len(annot['valid_frame'])))

    def __len__(self):
        return len(self.frame_indices)

    def __getitem__(self, index):
        import h5py

        frame_index = int(self.frame_indices[index])
        image_file = path.join(
            self.data_dir, self.seq_id, 'imageSequence',
            'img_%06d.jpg' % (frame_index + 1))
        with h5py.File(self.annot_file, 'r') as annot:
            return {
                'image_file': image_file,
                'seq_id': self.seq_id,
                'frame_index': frame_index,
                'valid': int(np.asarray(annot['valid_frame'][frame_index]).flatten()[0]),
                'annot2': np.asarray(annot['annot2'][frame_index][0]),
                'annot3': np.asarray(annot['annot3'][frame_index][0]),
                'univ_annot3': np.asarray(annot['univ_annot3'][frame_index][0]),
            }


class RawMpiTestDataset:
    SEQ_IDS = ['TS1', 'TS2', 'TS3', 'TS4', 'TS5', 'TS6']

    def __init__(self, data_dir, valid_only=True):
        self.seq_datasets = [
            RawMpiTestSeqDataset(data_dir, seq_id, valid_only=valid_only)
            for seq_id in self.SEQ_IDS
        ]
        self.data_dir = data_dir
        self.seq_indices = []
        self.frame_indices = []
        self.seq_start_indices = {}
        for seq_index, ds in enumerate(self.seq_datasets):
            self.seq_start_indices[ds.seq_id] = len(self.frame_indices)
            self.frame_indices += list(range(len(ds)))
            self.seq_indices += [seq_index] * len(ds)

    def __len__(self):
        return len(self.frame_indices)

    def __getitem__(self, index):
        return self.seq_datasets[self.seq_indices[index]][self.frame_indices[index]]

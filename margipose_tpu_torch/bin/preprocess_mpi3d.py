#!/usr/bin/env python3
"""Preprocess data from the MPI-INF-3DHP dataset
(reference: src/margipose/bin/preprocess_mpi3d.py).

The input files may be obtained from http://gvv.mpi-inf.mpg.de/3dhp-dataset/.

The port's copy of ``margipose_tpu/bin/preprocess_mpi3d.py``.
"""

from __future__ import annotations

import argparse
import sys
from os import listdir, path

from margipose_tpu_torch.data.mpi3d_preprocess import (
    preprocess_test_data,
    preprocess_training_data,
    preprocess_training_masks,
    preprocess_validation_data,
    preprocess_validation_masks,
)


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description='Preprocess data from the MPI-INF-3DHP dataset')
    parser.add_argument('-i', '--input-dir', type=str, metavar='DIR',
                        help='path to directory containing S1, S2, ...')
    parser.add_argument('-t', '--input-test-dir', type=str, metavar='DIR',
                        help='path to directory containing TS1, TS2, ...')
    parser.add_argument('-o', '--out-dir', type=str, metavar='DIR', required=True,
                        help='directory to write preprocessed data to')
    return parser.parse_args(argv[1:])


def assert_listing_contains(dir, expected):
    listing = listdir(dir)
    for child in expected:
        assert child in listing, f'{path.join(dir, child)} does not exist'


def main(argv=None):
    args = parse_args(argv or sys.argv)

    if args.input_dir:
        assert_listing_contains(
            args.input_dir, ['S1', 'S2', 'S3', 'S4', 'S5', 'S6', 'S7', 'S8'])
    if args.input_test_dir:
        assert_listing_contains(
            args.input_test_dir, ['TS1', 'TS2', 'TS3', 'TS4', 'TS5', 'TS6'])

    train_out_dir = path.join(args.out_dir, 'train')
    val_out_dir = path.join(args.out_dir, 'val')
    test_out_dir = path.join(args.out_dir, 'test')

    if args.input_dir:
        print('Starting data preprocessing (this may take several hours).')
        print('Training set')
        preprocess_training_data(args.input_dir, train_out_dir)
        print('Validation set')
        preprocess_validation_data(args.input_dir, val_out_dir)

    if args.input_test_dir:
        print('Test set')
        preprocess_test_data(args.input_test_dir, test_out_dir)

    if args.input_dir:
        print('Starting mask preprocessing.')
        print('Training set')
        preprocess_training_masks(train_out_dir)
        print('Validation set')
        preprocess_validation_masks(val_out_dir)

    print('All preprocessing has completed.')


if __name__ == '__main__':
    main()

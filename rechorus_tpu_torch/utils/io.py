"""Logging / formatting helpers (own copy of rechorus_tpu/utils/io.py).

The log-line grammar matches the reference (src/utils/utils.py:54-93,
src/helpers/BaseRunner.py:140-155) because the multi-seed experiment
harness regex-parses these lines -- the log format is an API.
"""
from __future__ import annotations

import logging
import os
import sys
from datetime import datetime
from typing import Dict


def format_metric(result_dict: Dict[str, float]) -> str:
    """'HR@5:0.3549,NDCG@5:0.2486' -- sorted like the reference.

    Reference behavior (src/utils/utils.py:54-69): keys sorted by the @k
    value first (ints before the metric name), floats rendered %.4f.
    """
    assert isinstance(result_dict, dict)
    format_str = []
    metrics = sorted(result_dict.keys(), key=lambda x: _metric_sort_key(x))
    for metric in metrics:
        m = result_dict[metric]
        if isinstance(m, (float,)) or hasattr(m, "dtype") and "float" in str(getattr(m, "dtype", "")):
            format_str.append("{}:{:<.4f}".format(metric, float(m)))
        elif isinstance(m, int) or (hasattr(m, "dtype") and "int" in str(getattr(m, "dtype", ""))):
            format_str.append("{}:{}".format(metric, int(m)))
        else:
            format_str.append("{}:{:<.4f}".format(metric, float(m)))
    return ",".join(format_str)


def _metric_sort_key(name: str):
    # sort by @k then metric name, mirroring reference's ordering of
    # '(HR@5, NDCG@5, HR@10, ...)' style outputs
    if "@" in name:
        metric, k = name.split("@", 1)
        try:
            return (0, int(k), metric)
        except ValueError:
            return (0, 0, name)
    return (1, 0, name)


def format_arg_str(args, exclude_lst: list, max_len: int = 20) -> str:
    """Render the parsed-args table (reference src/utils/utils.py:72-93)."""
    linesep = os.linesep
    arg_dict = vars(args)
    keys = [k for k in arg_dict.keys() if k not in exclude_lst]
    values = [arg_dict[k] for k in keys]
    key_title, value_title = "Arguments", "Values"
    key_max_len = max(map(lambda x: len(str(x)), keys + [key_title]))
    value_max_len = min(max(map(lambda x: len(str(x)), values + [value_title])), max_len)
    key_max_len, value_max_len = max([key_max_len, len(key_title)]), max([value_max_len, len(value_title)])
    horizon_len = key_max_len + value_max_len + 5
    res_str = linesep + "=" * horizon_len + linesep
    res_str += " " + key_title + " " * (key_max_len - len(key_title)) + " | " \
               + value_title + " " * (value_max_len - len(value_title)) + " " + linesep + "=" * horizon_len + linesep
    for key in sorted(keys):
        value = arg_dict[key]
        if value is not None:
            key_str, value_str = str(key), str(value).replace("\t", "\\t")
            value_str = value_str[:max_len - 3] + "..." if len(value_str) > max_len else value_str
            res_str += " " + key_str + " " * (key_max_len - len(key_str)) + " | " \
                       + value_str + " " * (value_max_len - len(value_str)) + linesep
    res_str += "=" * horizon_len
    return res_str


def check_dir(file_name: str) -> None:
    dir_path = os.path.dirname(file_name)
    if dir_path and not os.path.exists(dir_path):
        print("make dirs:", dir_path)
        os.makedirs(dir_path)


def non_increasing(lst: list) -> bool:
    """Early-stop predicate (reference src/utils/utils.py:103-104)."""
    return all(x >= y for x, y in zip(lst, lst[1:]))


def get_time() -> str:
    return datetime.now().strftime("%Y-%m-%d %H:%M:%S")


def init_logging(log_file: str | None, verbose: int = logging.INFO) -> None:
    """Log to file + stdout, like reference src/main.py:186-194."""
    for h in logging.root.handlers[:]:
        logging.root.removeHandler(h)
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file:
        check_dir(log_file)
        handlers.insert(0, logging.FileHandler(log_file))
    logging.basicConfig(level=verbose, format="%(message)s", handlers=handlers)

"""Human-survey CSV aggregation (+ scatter-plot helper).

The port's own copy of ``celebbasis_tpu/eval/survey.py`` (plain Python).
Parity: the reference's ``evaluation/survey/read_csv.py`` (per-question
preference counts from a survey CSV) and ``evaluation/paint`` (paper scatter
plots).  CSV contract: one row per respondent, one column per question, cell
values are the chosen option label (e.g. method A/B/C index).
"""
from __future__ import annotations

import csv
from collections import Counter
from typing import Dict, List, Sequence


def read_survey_csv(path: str, skip_cols: int = 1) -> List[List[str]]:
    """Rows of answers (first ``skip_cols`` columns dropped: timestamps etc)."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = [row[skip_cols:] for row in csv.reader(f)]
    return [r for r in rows[1:] if any(c.strip() for c in r)]  # drop header


def preference_counts(rows: Sequence[Sequence[str]]) -> List[Counter]:
    """Per-question Counter of chosen options."""
    n_q = max(len(r) for r in rows)
    counts = [Counter() for _ in range(n_q)]
    for row in rows:
        for qi, ans in enumerate(row):
            ans = ans.strip()
            if ans:
                counts[qi][ans] += 1
    return counts


def preference_rates(rows: Sequence[Sequence[str]]) -> Dict[str, float]:
    """Overall fraction of votes per option across all questions."""
    total = Counter()
    for c in preference_counts(rows):
        total.update(c)
    n = sum(total.values())
    return {k: v / n for k, v in sorted(total.items())}


def read_txt(txt_path: str, split_code: str = "\t"):
    """Tab-separated float rows -> (N, 2) array — the paint scripts' data
    contract (evaluation/paint/read_data.py:5-15)."""
    import numpy as np
    with open(txt_path) as f:
        rows = [[float(x) for x in line.strip().split(split_code)]
                for line in f if line.strip()]
    return np.asarray(rows)


def split_data(data, task_per_cls: int = 4):
    """Rows -> equal per-class chunks (scatter_by_class.py:18-20)."""
    import numpy as np
    return np.split(np.asarray(data), task_per_cls)


DEFAULT_CLASS_COLORS = ("blue", "black", "green", "red")
DEFAULT_TASK_MARKERS = ("o", "v", "s", "*")


def scatter_by_class(data, out_path: str, *,
                     n_classes: int = 4,
                     class_names: Sequence[str] = ("Textual Inversion",
                                                   "DreamBooth",
                                                   "Custom Diffusion",
                                                   "Ours"),
                     task_names: Sequence[str] = ("Style", "Single",
                                                  "With Celeb", "Double"),
                     colors: Sequence[str] = DEFAULT_CLASS_COLORS,
                     markers: Sequence[str] = DEFAULT_TASK_MARKERS,
                     xlabel: str = "Identity Similarity",
                     ylabel: str = "Prompt Similarity",
                     marker_size: int = 400):
    """The paper's class-wise scatter (scatter_by_class.py:24-111): one color
    per method class, one open marker per task row, a filled mean marker with
    x/y std error bars per class, and the reference's two legends (task
    markers lower-center, class means above the axes).

    ``data``: (n_classes*len(task_names), 2) rows (x, y) — e.g. from
    :func:`read_txt`.  Returns ``out_path`` (or None without matplotlib).
    """
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("[survey] matplotlib unavailable; skipping plot")
        return None
    import numpy as np

    plt.figure(figsize=(12, 9))
    ax = plt.subplot()
    plt.subplots_adjust(top=0.86)
    plt.xlabel(xlabel, fontsize=30)
    plt.ylabel(ylabel, fontsize=30)
    plt.yticks(size=25)
    plt.xticks(size=25)

    legend1 = None
    means_by_cls = []
    for idx, rows in enumerate(split_data(data, n_classes)):
        rows = np.asarray(rows)
        color = colors[idx % len(colors)]
        pxs = []
        for i in range(rows.shape[0]):        # open task markers
            pxs.append(plt.scatter(
                rows[i, 0], rows[i, 1], s=marker_size,
                marker=markers[i % len(markers)], facecolors="none",
                edgecolors=color, linewidths=3))
        x_mean, x_std = rows[:, 0].mean(), rows[:, 0].std()
        y_mean, y_std = rows[:, 1].mean(), rows[:, 1].std()
        px = plt.scatter(x_mean, y_mean, s=marker_size * 0.9, marker="o",
                         facecolors=color, edgecolors=color, linewidths=3)
        plt.errorbar(x_mean, y_mean, xerr=x_std, yerr=y_std, fmt="o",
                     color=color, ecolor=color, elinewidth=3, capsize=20,
                     capthick=3)
        pxs.append(px)
        means_by_cls.append(px)
        if idx == 1:                           # task legend (ref: idx==1)
            legend1 = ax.legend(pxs, list(task_names), fontsize=25,
                                loc="lower center", ncols=2)
    ax.legend(means_by_cls, list(class_names),
              bbox_to_anchor=(0.0, 1.07, 1.0, 0.102), loc="upper center",
              borderaxespad=0.0, ncols=2, fontsize=25, markerscale=0.75,
              edgecolor="none")
    if legend1 is not None:
        plt.gca().add_artist(legend1)
    plt.savefig(out_path, bbox_inches="tight", pad_inches=0.1)
    plt.close("all")
    return out_path


def scatter_plot(xs, ys, labels, out_path: str, xlabel: str = "",
                 ylabel: str = ""):
    """Paper-style labeled scatter (evaluation/paint parity); needs matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("[survey] matplotlib unavailable; skipping plot")
        return None
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.scatter(xs, ys)
    for x, y, lab in zip(xs, ys, labels):
        ax.annotate(lab, (x, y), fontsize=8,
                    textcoords="offset points", xytext=(4, 4))
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    fig.savefig(out_path, dpi=160)
    plt.close(fig)
    return out_path

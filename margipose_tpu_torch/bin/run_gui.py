#!/usr/bin/env python3
"""Browse dataset examples with predicted vs ground-truth skeletons.

Counterpart of ``margipose_tpu/bin/run_gui.py`` (reference:
src/margipose/bin/run_gui.py). Two modes:
  * interactive Tk GUI (when a display is available): browse examples,
    overlay predicted/GT skeletons, inspect per-joint xy/zy/xz heatmaps;
  * headless HTML report (``--export-html``, or no ``DISPLAY``): the same
    panels rendered for a sample of examples into a standalone HTML file.

The model runs in eval mode on ``--device``, float32 with TF32 off, one
example at a time; it computes no loss, so no kernel of the loss head runs.
The 3D pane needs matplotlib.
"""

from __future__ import annotations

import argparse
import base64
import io
import os

import sys

import numpy as np
import PIL.Image
import torch

from margipose_tpu_torch import resolve_device
from margipose_tpu_torch.bin.eval_3d import set_float32_parity_mode
from margipose_tpu_torch.checkpoint import load_model
from margipose_tpu_torch.cli import bin_subcommand
from margipose_tpu_torch.data.get_dataset import get_dataset
from margipose_tpu_torch.eval import gather_3d_metrics, prepare_for_3d_evaluation
from margipose_tpu_torch.geometry.coords import ensure_homogeneous
from margipose_tpu_torch.models import data_specs_for_desc, default_data_specs
from margipose_tpu_torch.utils import draw_skeleton_2d, seed_all


def parse_args(argv):
    parser = argparse.ArgumentParser(
        prog='margipose-gui', description='browse examples and predictions',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--model', type=str, metavar='FILE',
                        help='path to model file (optional)')
    parser.add_argument('--dataset', type=str, default='synthetic-64')
    parser.add_argument('--export-html', type=str, metavar='FILE', default=None,
                        help='write a headless HTML report to this file')
    parser.add_argument('--examples', type=int, default=8,
                        help='number of examples in the HTML report')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device the model runs on; 'cpu' runs on the host")
    return parser.parse_args(argv)


def _load_and_process_example(dataset, forward, index):
    example = dataset[index]
    inp = example['input']
    result = {'example': example, 'pred': None, 'metrics': None,
              'heatmaps': None, 'skel3d': None}
    has_depth = example.get('valid_depth', 1) == 1
    if forward is not None:
        xyz, out = forward(inp[None])
        pred = xyz.cpu().numpy().astype(np.float64)[0]
        result['pred'] = pred
        result['heatmaps'] = {
            'xy': out.xy_heatmaps[-1][0].cpu().numpy(),
            'zy': out.zy_heatmaps[-1][0].cpu().numpy(),
            'xz': out.xz_heatmaps[-1][0].cpu().numpy(),
        }
        if has_depth:
            expected, actual = prepare_for_3d_evaluation(
                example['original_skel'], ensure_homogeneous(pred, 3), dataset,
                example['camera_intrinsic'], example['transform_opts'])
            result['metrics'] = gather_3d_metrics(expected, actual)
            result['skel3d'] = {'expected': expected, 'actual': actual}
    if result['skel3d'] is None and has_depth:
        # no model: ground-truth-only 3D view, like the reference GUI with
        # --model omitted (reference: src/margipose/bin/run_gui.py:252-262);
        # the eval-space conversion is shared with the metrics pipeline
        from margipose_tpu_torch.eval import expected_3d_skeleton

        result['skel3d'] = {
            'expected': expected_3d_skeleton(example['original_skel'], dataset),
            'actual': None,
        }
    return result


def _skeleton_3d_panel(skel3d, aligned=False, size=320):
    """Pred-vs-GT root-relative skeleton wireframes on a 3D axes as a PIL
    image: prediction opaque, ground truth translucent, Procrustes-aligned
    prediction when ``aligned`` (reference: src/margipose/bin/run_gui.py:
    249-278, plot helper src/margipose/utils.py:124-170)."""
    import matplotlib

    matplotlib.use('Agg', force=False)
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    from margipose_tpu_torch.geometry.skeleton import (
        CanonicalSkeletonDesc,
        apply_rigid_alignment,
    )
    from margipose_tpu_torch.utils import plot_skeleton_on_axes3d

    fig = Figure(figsize=(size / 100, size / 100), dpi=100)
    canvas = FigureCanvasAgg(fig)
    ax = fig.add_subplot(1, 1, 1, projection='3d')
    expected = np.asarray(skel3d['expected'], np.float64)
    if skel3d.get('actual') is not None:
        actual = np.asarray(skel3d['actual'], np.float64)
        if aligned:
            actual = apply_rigid_alignment(actual, expected)
        plot_skeleton_on_axes3d(actual, CanonicalSkeletonDesc, ax, alpha=1.0)
        plot_skeleton_on_axes3d(expected, CanonicalSkeletonDesc, ax, alpha=1 / 3)
    else:
        plot_skeleton_on_axes3d(expected, CanonicalSkeletonDesc, ax, alpha=1.0)
    # equal aspect around the root so pose proportions read correctly
    lim = max(float(np.abs(expected).max()), 1.0) * 1.1
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-lim, lim)
    ax.set_title('aligned' if aligned else 'camera space', fontsize=8)
    canvas.draw()
    w, h = canvas.get_width_height()
    img = PIL.Image.frombuffer('RGBA', (w, h), canvas.buffer_rgba()).convert('RGB')
    fig.clf()
    return img


def _overlay_image(dataset, example, pred):
    img = dataset.input_to_pil_image(np.asarray(example['input']))
    # GT in green via image-space projection
    gt = dataset.to_image_space(
        example['index'],
        ensure_homogeneous(np.asarray(example['target'], np.float64), 3),
        example['camera_intrinsic'])
    import PIL.ImageDraw as ImageDraw

    draw = ImageDraw.Draw(img)
    for j, parent in enumerate(dataset.skeleton_desc.joint_tree):
        if j != parent:
            draw.line([tuple(gt[j][:2]), tuple(gt[parent][:2])],
                      fill=(0, 255, 0), width=1)
    if pred is not None:
        skel2d = dataset.to_image_space(
            example['index'], ensure_homogeneous(pred, 3),
            example['camera_intrinsic'])
        draw_skeleton_2d(img, skel2d, dataset.skeleton_desc)
    return img


def _heatmap_panel(hm, size=96, overlay=None):
    """One heatmap as a PIL image with DSNT-mean crosshairs
    (reference: src/margipose/bin/run_gui.py:336-351)."""
    import PIL.ImageDraw as ImageDraw

    hm = np.asarray(hm, np.float64)
    total = hm.sum() + 1e-12
    # Weighted mean of each axis — the soft-argmax the model reads out.
    mean_x = float((hm.sum(-2) * np.arange(hm.shape[-1])).sum() / total)
    mean_y = float((hm.sum(-1) * np.arange(hm.shape[-2])).sum() / total)
    arr = (np.clip(hm / (hm.max() + 1e-12), 0, 1) * 255).astype(np.uint8)
    img = PIL.Image.fromarray(arr).convert('RGB').resize(
        (size, size), PIL.Image.NEAREST)
    if overlay is not None:
        img = PIL.Image.blend(img, overlay.resize((size, size)), 0.5)
    scale = size / hm.shape[-1]
    draw = ImageDraw.Draw(img)
    draw.line([(mean_x * scale, 0), (mean_x * scale, size)], fill=(255, 64, 64))
    draw.line([(0, mean_y * scale), (size, mean_y * scale)], fill=(255, 64, 64))
    return img


def _heatmap_strip(heatmaps, joint, image=None):
    """xy/xz/zy heatmaps for one joint as a horizontal image strip, with
    mean crosshairs and the input image alpha-blended under the xy plane."""
    panels = []
    for key in ('xy', 'xz', 'zy'):
        overlay = image if key == 'xy' else None
        panels.append(_heatmap_panel(heatmaps[key][joint], overlay=overlay))
    strip = PIL.Image.new('RGB', (96 * 3 + 8, 96))
    for i, p in enumerate(panels):
        strip.paste(p, (i * (96 + 4), 0))
    return strip


def _img_to_b64(img):
    buf = io.BytesIO()
    img.save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode()


def export_html(dataset, forward, out_file, n_examples):
    """Standalone HTML report with the reference GUI's capabilities
    (reference: src/margipose/bin/run_gui.py:103-404): per-example overlay,
    a per-joint xy/xz/zy heatmap viewer behind a joint <select>, and a
    Procrustes-alignment toggle that switches the displayed metrics."""
    joint_names = dataset.skeleton_desc.joint_names
    rows = []
    n = min(n_examples, len(dataset))
    for i in range(n):
        r = _load_and_process_example(dataset, forward, i)
        overlay = _overlay_image(dataset, r['example'], r['pred'])
        cells = [f'<td><img src="data:image/png;base64,{_img_to_b64(overlay)}"></td>']
        if r['skel3d'] is not None:
            # two pre-rendered variants behind the Procrustes toggle;
            # a GT-only pane (no prediction) has nothing to align, so it
            # stays visible in both toggle states
            plain3d = _skeleton_3d_panel(r['skel3d'], aligned=False)
            if r['skel3d'].get('actual') is not None:
                aligned3d = _skeleton_3d_panel(r['skel3d'], aligned=True)
                cell = (f'<td><img class="plain" src="data:image/png;base64,'
                        f'{_img_to_b64(plain3d)}">'
                        f'<img class="aligned" style="display:none" '
                        f'src="data:image/png;base64,{_img_to_b64(aligned3d)}">')
            else:
                cell = (f'<td><img src="data:image/png;base64,'
                        f'{_img_to_b64(plain3d)}">')
            cells.append(cell + '<br><small>3D: prediction opaque, ground '
                                'truth translucent</small></td>')
        if r['heatmaps'] is not None:
            img = dataset.input_to_pil_image(np.asarray(r['example']['input']))
            strips = []
            for j, name in enumerate(joint_names):
                strip = _heatmap_strip(r['heatmaps'], j, image=img)
                display = 'inline' if j == 0 else 'none'
                strips.append(
                    f'<img class="hm hm-{j}" style="display:{display}" '
                    f'src="data:image/png;base64,{_img_to_b64(strip)}">')
            cells.append(
                f'<td>{"".join(strips)}<br><small>xy / xz / zy marginal '
                f'heatmaps (crosshairs = soft-argmax mean)</small></td>')
        if r['metrics'] is not None:
            m = r['metrics']
            cells.append(
                '<td><span class="plain">'
                f"MPJPE {m['mpjpe']:.1f}mm<br>PCK {m['pck']:.3f}"
                f"<br>AUC {m['auc']:.3f}</span>"
                '<span class="aligned" style="display:none">'
                f"MPJPE {m['aligned_mpjpe']:.1f}mm<br>PCK {m['aligned_pck']:.3f}"
                f"<br>AUC {m['aligned_auc']:.3f}</span></td>")
        rows.append(f"<tr><td>#{i}</td>{''.join(cells)}</tr>")
    options = ''.join(f'<option value="{j}">{name}</option>'
                      for j, name in enumerate(joint_names))
    controls = (
        f'<p>Joint: <select id="joint">{options}</select> '
        '<label><input type="checkbox" id="aligned"> Procrustes alignment'
        '</label></p>'
        '<script>\n'
        'document.getElementById("joint").addEventListener("change", e => {\n'
        '  document.querySelectorAll(".hm").forEach(el => {\n'
        '    el.style.display = el.classList.contains("hm-" + e.target.value)'
        ' ? "inline" : "none";\n  });\n});\n'
        'document.getElementById("aligned").addEventListener("change", e => {\n'
        '  const on = e.target.checked;\n'
        '  document.querySelectorAll(".plain").forEach(el => '
        'el.style.display = on ? "none" : "inline");\n'
        '  document.querySelectorAll(".aligned").forEach(el => '
        'el.style.display = on ? "inline" : "none");\n});\n'
        '</script>')
    html = (
        '<html><head><title>margipose_tpu_torch examples</title></head><body>'
        '<h1>margipose_tpu_torch example browser</h1>'
        '<p>green = ground truth; red/blue/gold = prediction</p>'
        f'<table border="1">{"".join(rows)}</table>'
        f'{controls}</body></html>'
    )
    with open(out_file, 'w') as f:
        f.write(html)
    print(f'wrote {out_file} ({n} examples, {len(joint_names)} joints)')


def run_tk_gui(dataset, forward):
    """Interactive browser with the reference GUI's toolbar surface
    (reference: src/margipose/bin/run_gui.py:103-404): example stepper,
    MPJPE/PCK readout with a Procrustes-alignment toggle, and a per-joint
    xy/xz/zy heatmap viewer behind a joint dropdown."""
    import tkinter as tk
    from PIL import ImageTk

    root = tk.Tk()
    root.title('margipose_tpu_torch GUI')
    state = {'index': 0, 'result': None}
    joint_names = list(dataset.skeleton_desc.joint_names)
    var_joint = tk.StringVar(value=joint_names[0])
    var_aligned = tk.IntVar(value=0)

    panes = tk.Frame(root)
    panes.pack()
    img_label = tk.Label(panes)
    img_label.pack(side=tk.LEFT)
    skel3d_label = tk.Label(panes)
    skel3d_label.pack(side=tk.LEFT)
    hm_label = tk.Label(root)
    hm_label.pack()
    hm_caption = tk.Label(root, text='')
    hm_caption.pack()
    info = tk.Label(root, text='')
    info.pack()

    def refresh_heatmaps():
        r = state['result']
        if r is None or r['heatmaps'] is None:
            hm_label.configure(image='')
            hm_caption.configure(text='')
            return
        joint = joint_names.index(var_joint.get())
        img = dataset.input_to_pil_image(np.asarray(r['example']['input']))
        strip = _heatmap_strip(r['heatmaps'], joint, image=img)
        strip = strip.resize((strip.width * 2, strip.height * 2),
                             PIL.Image.NEAREST)
        photo = ImageTk.PhotoImage(strip)
        hm_label.configure(image=photo)
        hm_label.image = photo
        hm_caption.configure(
            text=f'{var_joint.get()}: xy / xz / zy marginal heatmaps '
                 '(crosshairs = soft-argmax mean)')

    def refresh_skeleton_3d():
        r = state['result']
        if r is None or r['skel3d'] is None:
            skel3d_label.configure(image='')
            return
        panel = _skeleton_3d_panel(r['skel3d'], aligned=bool(var_aligned.get()),
                                   size=512)
        photo = ImageTk.PhotoImage(panel)
        skel3d_label.configure(image=photo)
        skel3d_label.image = photo

    def refresh_info():
        r = state['result']
        text = f"example {state['index'] + 1}/{len(dataset)}"
        if r and r['metrics']:
            m = r['metrics']
            if var_aligned.get():
                text += (f"   aligned MPJPE {m['aligned_mpjpe']:.1f}mm  "
                         f"aligned PCK {m['aligned_pck']:.3f}")
            else:
                text += f"   MPJPE {m['mpjpe']:.1f}mm  PCK {m['pck']:.3f}"
        info.configure(text=text)

    def refresh():
        r = _load_and_process_example(dataset, forward, state['index'])
        state['result'] = r
        overlay = _overlay_image(dataset, r['example'], r['pred'])
        overlay = overlay.resize((512, 512), PIL.Image.NEAREST)
        photo = ImageTk.PhotoImage(overlay)
        img_label.configure(image=photo)
        img_label.image = photo
        refresh_skeleton_3d()
        refresh_heatmaps()
        refresh_info()

    def step(delta):
        state['index'] = (state['index'] + delta) % len(dataset)
        refresh()

    controls = tk.Frame(root)
    controls.pack()
    tk.Button(controls, text='< prev', command=lambda: step(-1)).pack(side=tk.LEFT)
    tk.Button(controls, text='next >', command=lambda: step(1)).pack(side=tk.LEFT)
    tk.Label(controls, text='  Joint:').pack(side=tk.LEFT)
    tk.OptionMenu(controls, var_joint, *joint_names,
                  command=lambda _=None: refresh_heatmaps()).pack(side=tk.LEFT)
    def on_aligned_toggle():
        refresh_skeleton_3d()
        refresh_info()

    tk.Checkbutton(controls, text='Procrustes alignment', variable=var_aligned,
                   command=on_aligned_toggle).pack(side=tk.LEFT)
    refresh()
    root.mainloop()


def make_forward(model, device):
    """``forward(images)``: a host NHWC float32 batch -> the model's
    ``(xyz, ModelOutput)`` on ``device``, in eval mode, no gradients."""
    def forward(images):
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).permute(0, 3, 1, 2)
        with torch.inference_mode():
            return model(x.to(device))

    return forward


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    seed_all(12345)
    device = resolve_device(args.device)

    model_desc = None
    model = None
    if args.model:
        set_float32_parity_mode()
        model, model_desc = load_model(args.model, device)
    specs = data_specs_for_desc(model_desc) if model_desc else default_data_specs()
    dataset = get_dataset(args.dataset, specs, use_aug=False)

    forward = make_forward(model, device) if model is not None else None

    if args.export_html or not os.environ.get('DISPLAY'):
        out_file = args.export_html or 'gui_report.html'
        export_html(dataset, forward, out_file, args.examples)
    else:
        run_tk_gui(dataset, forward)


GUI_Subcommand = bin_subcommand('gui', main, help='browse dataset examples')

if __name__ == '__main__':
    main()

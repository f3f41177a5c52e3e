"""Production server CLI.

`python -m mec_tpu_torch serve [--port 5000] [--models-dir DIR] [--warmup]
[--device cuda]` (or `python -m mec_tpu_torch.webapp.serve`)

The port's copy of mec_tpu/webapp/serve.py: the same flags, plus
--device (default cuda; cpu for a machine without a card). One process
owns the card; werkzeug's threaded WSGI server front-ends it, and the
micro-batcher coalesces concurrent requests into one device dispatch.
--warmup runs every batch bucket's serving shapes before accepting
traffic (the kernels' first-call work and the allocator).
"""

from __future__ import annotations

import argparse

from mec_tpu_torch.config import Config
from mec_tpu_torch.webapp.app import create_app


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='Serve the emotion classifier')
    p.add_argument('--host', default='0.0.0.0')
    p.add_argument('--port', type=int, default=5000)
    p.add_argument('--models-dir', default=None)
    p.add_argument('--warmup', action='store_true',
                   help='run all batch buckets before serving')
    # deprecated no-op, as in the JAX CLI: werkzeug serves one thread per
    # connection with no pool-size knob; kept so launch scripts written
    # for the flag don't fail with an argparse error
    p.add_argument('--threads', type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument('--device', default='cuda',
                   help="the engine's device: cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.threads is not None:
        print('warning: --threads is deprecated and ignored '
              '(thread-per-connection server)', flush=True)

    app = create_app(models_dir=args.models_dir, device=args.device)
    if args.warmup:
        print(f'Warming up buckets {Config.BATCH_BUCKETS}...', flush=True)
        app.engine.warmup(Config.BATCH_BUCKETS)

    from werkzeug.serving import run_simple
    print(f'Serving on http://{args.host}:{args.port} '
          f'(thread-per-connection, 1 engine on {args.device})', flush=True)
    run_simple(args.host, args.port, app, threaded=True,
               processes=1, use_reloader=False)


def make_wsgi_app():
    """WSGI factory (parity with reference wsgi.py); e.g.
    `gunicorn 'mec_tpu_torch.webapp.serve:make_wsgi_app()' --threads 8
    -w 1` (ONE worker: the process owns the card)."""
    return create_app()


if __name__ == '__main__':
    main()

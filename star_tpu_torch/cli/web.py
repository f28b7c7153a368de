"""Minimal web front-end over the file-queue serve daemon (the port's own
copy of star_tpu/cli/web.py: the same endpoints and queue protocol,
standard library only).

Deployment-story counterpart of the reference's gradio/streamlit demos
(cogvideox-based/inference/gradio_web_demo.py, web_demo.py — stock T2V
UIs): here the web tier is a stateless stdlib HTTPServer that bridges
HTTP to the `cli.serve` filesystem queue, so the card stays owned by one
resident daemon process and any number of web workers can front it.

Endpoints:
  GET  /              HTML form + live job table
  POST /enqueue       form fields or JSON {input_path, prompt, seed,
                      output_name} -> {"job": <name>}
  PUT  /upload/<name> raw video bytes -> saved under --upload_dir; the
                      returned path can be used as input_path
  GET  /jobs          JSON state of every queued/working/done job
  GET  /result/<job>  the done-file JSON (404 while pending)
  GET  /video/<file>  the rendered output video from --save_dir

Run (next to a `python -m star_tpu_torch.cli.serve --queue_dir q ...`
daemon):
    python -m star_tpu_torch.cli.web --queue_dir q --save_dir results \
        --port 7860
"""

from __future__ import annotations

import json
import os
import re
import time
import urllib.parse
from argparse import ArgumentParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_NAME_RE = re.compile(r'^[A-Za-z0-9._-]{1,128}$')

_PAGE = """<!doctype html><html><head><title>star-tpu SR</title>
<style>body{{font-family:sans-serif;max-width:52em;margin:2em auto}}
td,th{{padding:.25em .8em;border-bottom:1px solid #ddd;text-align:left}}
input,button{{margin:.2em 0}}</style></head><body>
<h2>star-tpu video super-resolution</h2>
<form method=post action=/enqueue>
<label>input path <input name=input_path size=48 required></label><br>
<label>prompt <input name=prompt size=48 value="a good video"></label><br>
<label>seed <input name=seed value=666 size=8></label>
<label>output name <input name=output_name size=24></label><br>
<button>enqueue</button></form>
<h3>jobs</h3><table><tr><th>job</th><th>state</th><th>result</th></tr>
{rows}</table>
<p>API: POST /enqueue (JSON), GET /jobs, GET /result/&lt;job&gt;,
PUT /upload/&lt;name&gt;</p></body></html>"""


def job_states(queue_dir: str) -> dict[str, dict]:
    """name -> {state: queued|working|done, result?: dict}."""
    jobs: dict[str, dict] = {}
    try:
        entries = sorted(os.listdir(queue_dir))
    except FileNotFoundError:
        return jobs
    for f in entries:
        if f.endswith('.done.json'):
            name = f[:-len('.done.json')]
            try:
                with open(os.path.join(queue_dir, f)) as fh:
                    jobs[name] = {'state': 'done', 'result': json.load(fh)}
            except (OSError, ValueError):
                jobs[name] = {'state': 'done'}
        elif f.endswith('.json.working'):
            jobs.setdefault(f[:-len('.json.working')], {'state': 'working'})
        elif f.endswith('.json'):
            jobs.setdefault(f[:-len('.json')], {'state': 'queued'})
    return jobs


def make_handler(queue_dir: str, save_dir: str, upload_dir: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet; tests drive many reqs
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = 'application/json') -> None:
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode())

        # ------------------------------------------------------------- GET
        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == '/':
                rows = ''.join(
                    f'<tr><td>{n}</td><td>{j["state"]}</td>'
                    f'<td>{json.dumps(j.get("result", ""))}</td></tr>'
                    for n, j in sorted(job_states(queue_dir).items()))
                self._send(200, _PAGE.format(rows=rows).encode(),
                           'text/html; charset=utf-8')
            elif path == '/jobs':
                self._json(200, job_states(queue_dir))
            elif path.startswith('/result/'):
                name = path[len('/result/'):]
                if not _NAME_RE.match(name):
                    return self._json(400, {'error': 'bad job name'})
                done = os.path.join(queue_dir, name + '.done.json')
                if not os.path.exists(done):
                    state = job_states(queue_dir).get(name, {})
                    return self._json(404, {'state': state.get('state',
                                                               'unknown')})
                with open(done, 'rb') as f:
                    self._send(200, f.read())
            elif path.startswith('/video/'):
                name = path[len('/video/'):]
                if not _NAME_RE.match(name):
                    return self._json(400, {'error': 'bad file name'})
                fp = os.path.join(save_dir, name)
                if not os.path.exists(fp):
                    return self._json(404, {'error': 'not found'})
                with open(fp, 'rb') as f:
                    self._send(200, f.read(), 'video/mp4')
            else:
                self._json(404, {'error': 'unknown path'})

        # ------------------------------------------------------------ POST
        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            if path != '/enqueue':
                return self._json(404, {'error': 'unknown path'})
            n = int(self.headers.get('Content-Length', 0))
            raw = self.rfile.read(n)
            ctype = self.headers.get('Content-Type', '')
            try:
                if 'json' in ctype:
                    req = json.loads(raw)
                else:
                    form = urllib.parse.parse_qs(raw.decode())
                    req = {k: v[0] for k, v in form.items() if v and v[0]}
            except (ValueError, UnicodeDecodeError) as e:
                return self._json(400, {'error': str(e)})
            if 'input_path' not in req:
                return self._json(400, {'error': 'input_path required'})
            req.setdefault('prompt', 'a good video')
            req['seed'] = int(req.get('seed', 666))
            name = f'web-{int(time.time() * 1000):x}'
            tmp = os.path.join(queue_dir, name + '.tmp')
            with open(tmp, 'w') as f:
                json.dump(req, f)
            os.rename(tmp, os.path.join(queue_dir, name + '.json'))
            self._json(200, {'job': name})

        # ------------------------------------------------------------- PUT
        def do_PUT(self):
            path = urllib.parse.urlparse(self.path).path
            if not path.startswith('/upload/'):
                return self._json(404, {'error': 'unknown path'})
            name = path[len('/upload/'):]
            if not _NAME_RE.match(name):
                return self._json(400, {'error': 'bad upload name'})
            n = int(self.headers.get('Content-Length', 0))
            os.makedirs(upload_dir, exist_ok=True)
            fp = os.path.join(upload_dir, name)
            with open(fp, 'wb') as f:
                remaining = n
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 20))
                    if not chunk:
                        break
                    f.write(chunk)
                    remaining -= len(chunk)
            self._json(200, {'input_path': os.path.abspath(fp)})

    return Handler


def serve_web(queue_dir: str, save_dir: str, upload_dir: str,
              host: str = '127.0.0.1', port: int = 7860
              ) -> ThreadingHTTPServer:
    """Build (but don't run) the server — tests drive it from a thread."""
    os.makedirs(queue_dir, exist_ok=True)
    handler = make_handler(queue_dir, save_dir, upload_dir)
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--queue_dir', required=True)
    p.add_argument('--save_dir', default='results')
    p.add_argument('--upload_dir', default='uploads')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=7860)
    args = p.parse_args(argv)
    srv = serve_web(args.queue_dir, args.save_dir, args.upload_dir,
                    args.host, args.port)
    print(f'web front-end on http://{args.host}:{args.port} '
          f'(queue={args.queue_dir})', flush=True)
    srv.serve_forever()


if __name__ == '__main__':
    main()

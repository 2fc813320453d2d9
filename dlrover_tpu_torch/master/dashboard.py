"""Job dashboard: live operational surface over HTTP (JSON + web UI).

Copy of ``dlrover_tpu/master/dashboard.py``, the counterpart of DLRover's
``dlrover/dashboard`` (Tornado UI attached via ``--enable_dashboard``,
integrate_with_master.py; 2.7k LoC web app): a dependency-free status
server over the master's in-memory state, with the same routes, page and
JSON.  Every master attribute is optional; ``/brain`` answers
``{"enabled": false}`` while no brain is attached (the port has none
yet).  ``stop()`` joins the serving thread, so no listener outlives it.  JSON
endpoints first (``curl | jq`` is the operator's API), with a single-page
UI on top:

  /status       job summary: stage, step, speed, goodput, nodes, hang
  /nodes        per-node detail incl. latest metrics + laggard flags
  /node?id=N    one node's bounded metric history (resource/steps/hang)
  /rendezvous   each rendezvous manager's round/waiting/params state
  /datasets     dynamic-sharding progress per dataset (todo/doing/done)
  /stats        throughput history records (sparkline source)
  /events       the master's recent event ring (node lifecycle, relaunch)
  /diagnosis    hang verdict + queued diagnosis actions
  /incidents    flight-recorder incidents: kind, classified
                phase/culprit/stuck-op, chaos attribution, dump
                inventory + artifact dir (INCIDENT.json, merged
                Perfetto incident timeline)
  /ckpt         distributed checkpoint commits: per-dir committed step
                + recent two-phase commit attempts (hosts reported vs
                expected, sealed, bytes written, seal errors)
  /comm         the comm observatory: probe-measured per-axis fabric
                latency/bandwidth (worst-case job rollups + per-node
                latest samples) and any open slow_link incidents —
                "which link is slow" as one JSON page
  /mem          the memory observatory: per-node HBM/host byte
                accounts (used/limit/headroom, per-subsystem
                attribution, host RSS + shm staging), worst-case job
                rollups, and any open hbm_leak/mem_pressure/hbm_oom
                incidents — "who owns the bytes / how close to OOM"
                as one JSON page
  /compile      the compile observatory: per-node cumulative compile
                seconds / persistent-cache hits+misses / dispatch
                stalls with the warm-expected and cache-enabled flags,
                job rollups (recent compile s, worst hit ratio), and
                any open recompile_storm/cache_cold incidents —
                "which function recompiled and why" as one JSON page
  /data         the data-pipeline observatory (datascope): per-dataset
                and aggregate shard telemetry — backlog depth, lease
                p50/p99 service latency, queue wait, shards/s — plus
                the recent job.data.* series; "is the input pipeline
                keeping up" as one JSON page
  /timeseries   the master time-series store (goodput ledger shares,
                step-time history) at 1s/10s/5m downsampled
                resolutions; ?name=<prefix>&res=<seconds> filter —
                the dashboard goodput sparkline's source
  /metrics      control-plane RED metrics (Prometheus text): per-RPC
                rate/error/duration histograms, retry + breaker
                counters, checkpoint phase durations, goodput — the
                page a cluster Prometheus (or timer/daemon.py) scrapes
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from dlrover_tpu_torch.common.constants import NodeType

_PAGE = """<!doctype html><html><head><title>dlrover-tpu job</title>
<style>
body{font-family:monospace;margin:1.5em;background:#fafafa;color:#222}
table{border-collapse:collapse;margin:.5em 0}
td,th{border:1px solid #bbb;padding:3px 9px;text-align:left}
th{background:#eee}
h2,h3{margin:.6em 0 .2em}
.bad{color:#b00020;font-weight:bold}
.ok{color:#1b5e20}
.section{margin-bottom:1em}
#spark{border:1px solid #bbb;background:#fff}
.bar{display:inline-block;height:10px;background:#3367d6}
.barbox{display:inline-block;width:120px;height:10px;background:#ddd}
#events{max-height:260px;overflow-y:auto;background:#fff;
border:1px solid #bbb;padding:4px;font-size:12px}
#hang{display:none;background:#ffebee;border:1px solid #b00020;
padding:6px;margin:.5em 0}
</style></head><body>
<h2>dlrover-tpu job: <span id=job></span></h2>
<p>stage: <b id=stage></b> | step: <b id=step></b> |
speed: <b id=speed></b> steps/s | goodput: <b id=goodput></b> |
<a href=incidents>incidents</a> | <a href=ckpt>ckpt</a> |
<a href=recovery>recovery</a> |
<a href=comm>comm</a> | <a href=mem>mem</a> |
<a href=compile>compile</a> | <a href=brain>brain</a> |
<a href=metrics>metrics</a></p>
<div id=hang></div>
<div class=section><h3>throughput (steps/s)</h3>
<svg id=spark width=480 height=60></svg></div>
<div class=section><h3>goodput ledger
(<a href="timeseries?name=job.">json</a>)</h3>
<svg id=gpspark width=480 height=60></svg>
<div id=gpphases style="font-size:12px"></div></div>
<div class=section><h3>fabric (<a href=comm>json</a>)</h3>
<table id=fabric><tr><th>axis</th><th>latency µs (worst)</th>
<th>GB/s (worst)</th><th>probing nodes</th></tr></table></div>
<div class=section><h3>memory (<a href=mem>json</a>)</h3>
<table id=memtab><tr><th>node</th><th>used GiB</th><th>limit GiB</th>
<th>headroom</th><th>rss GiB</th><th>shm GiB</th>
<th>top subsystems</th></tr></table></div>
<div class=section><h3>compile (<a href=compile>json</a>)</h3>
<table id=compiletab><tr><th>node</th><th>compile s</th>
<th>hits</th><th>misses</th><th>hit ratio</th><th>stalls</th>
<th>warm?</th><th>cache?</th></tr></table></div>
<div class=section><h3>nodes</h3>
<table id=nodes><tr><th>id</th><th>status</th><th>relaunches</th>
<th>heartbeat age (s)</th><th>cpu %</th><th>mem MB</th><th>step</th>
<th>duty %</th><th>hbm</th><th>flags</th></tr></table></div>
<div class=section><h3>rendezvous</h3>
<table id=rdzv><tr><th>name</th><th>round</th><th>waiting</th>
<th>min/max</th><th>node unit</th><th>not joined</th></tr></table></div>
<div class=section><h3>datasets</h3>
<table id=datasets><tr><th>name</th><th>epoch</th><th>done</th>
<th>doing</th><th>todo</th><th>progress</th></tr></table></div>
<div class=section><h3>diagnosis</h3>
<table id=diag><tr><th>kind</th><th>detail</th></tr></table></div>
<div class=section><h3>incidents (<a href=incidents>json</a>)</h3>
<table id=incidents><tr><th>id</th><th>kind</th><th>phase</th>
<th>culprit</th><th>stuck op</th><th>chaos</th><th>dumps</th>
<th>detail</th></tr></table></div>
<div class=section><h3>checkpoint commits (<a href=ckpt>json</a>)</h3>
<table id=ckpt><tr><th>dir</th><th>committed</th><th>step</th>
<th>hosts</th><th>sealed</th><th>MB written</th><th>error</th></tr>
</table></div>
<div class=section><h3>recent events</h3><div id=events></div></div>
<script>
function cell(r, v, cls){const c=r.insertCell();
  c.textContent = v===null||v===undefined ? '-' : v;
  if(cls) c.className = cls; return c;}
function clear(t){while(t.rows.length>1) t.deleteRow(1);}
async function get(p){return (await fetch(p)).json();}
async function refresh(){
  const s = await get('status');
  job.textContent = s.job; stage.textContent = s.stage;
  step.textContent = s.step; speed.textContent = s.speed.toFixed(2);
  goodput.textContent = (s.goodput*100).toFixed(1)+'%';
  const hangBox = document.getElementById('hang');
  if(s.hang && s.hang.hung_nodes && s.hang.hung_nodes.length){
    hangBox.style.display='block';
    hangBox.textContent = 'HANG: nodes '+s.hang.hung_nodes.join(',')
      +(s.hang.summary?(' — '+s.hang.summary):'');
  } else hangBox.style.display='none';
  const lag = new Set(s.step_laggards||[]);
  const dutyLag = new Set(s.duty_laggards||[]);
  const hbm = s.hbm_pressure||{};
  const t = document.getElementById('nodes'); clear(t);
  for(const n of s.nodes){const r=t.insertRow();
    cell(r,n.id); cell(r,n.status,
      n.status==='failed'||n.status==='deleted'?'bad':
      (n.status==='running'?'ok':''));
    cell(r,n.relaunch_count); cell(r,n.heartbeat_age);
    const m = n.metrics||{}; const res=m.resource||{};
    cell(r,res.cpu_percent!==undefined?res.cpu_percent.toFixed(0):null);
    cell(r,res.memory_mb); cell(r,m.step?m.step.step:null);
    const chips=(m.device&&m.device.chips)||[];
    const duties=chips.map(c=>c.duty_cycle_pct).filter(v=>v>=0);
    cell(r,duties.length?
      (duties.reduce((a,b)=>a+b,0)/duties.length).toFixed(0):null,
      dutyLag.has(n.id)?'bad':'');
    const hp = hbm[String(n.id)];
    cell(r,hp!==undefined?(hp*100).toFixed(0)+'%':null,
      hp>0.92?'bad':'');
    const flags=[lag.has(n.id)?'LAGGING':'',
      dutyLag.has(n.id)?'DUTY-LAG':''].filter(Boolean).join(' ');
    cell(r,flags, flags?'bad':'');}
  const rz = await get('rendezvous');
  const rt = document.getElementById('rdzv'); clear(rt);
  for(const [name,v] of Object.entries(rz)){const r=rt.insertRow();
    cell(r,name); cell(r,v.round); cell(r,v.waiting);
    cell(r,v.min_nodes+'/'+v.max_nodes); cell(r,v.node_unit);
    cell(r,(v.not_joined||[]).join(',')||'-',
      (v.not_joined||[]).length?'bad':'');}
  const ds = await get('datasets');
  const dt = document.getElementById('datasets'); clear(dt);
  for(const [name,v] of Object.entries(ds)){const r=dt.insertRow();
    cell(r,name); cell(r,v.epoch); cell(r,v.completed); cell(r,v.doing);
    cell(r,v.todo);
    const total = v.completed+v.doing+v.todo;
    const pct = total? Math.round(100*v.completed/total):0;
    const c = r.insertCell();
    c.innerHTML = '<span class=barbox><span class=bar style="width:'
      +(1.2*pct)+'px"></span></span> '+pct+'%';}
  const st = await get('stats');
  drawSpark('spark', (st.records||[]).map(r=>r.speed));
  const tsj = await get('timeseries?name=job.&res=10');
  const gp = (tsj.series||{})['job.goodput']||[];
  drawSpark('gpspark', gp.map(p=>p.mean), 1.0);
  const shares = Object.entries(tsj.series||{})
    .filter(([k,v])=>k.startsWith('job.share.')&&v.length)
    .map(([k,v])=>k.slice(10)+' '
      +(100*v[v.length-1].mean).toFixed(0)+'%');
  document.getElementById('gpphases').textContent =
    shares.length?('recent shares: '+shares.join(' | ')):'';
  // /diagnosis copies state under the JobContext lock: poll it at a
  // slower cadence than the 3s refresh (every 5th tick); the hang
  // verdict itself already rides /status into the banner above
  if((refresh.tick = (refresh.tick||0)+1) % 5 === 1){
  const dg = await get('diagnosis');
  const dgt = document.getElementById('diag'); clear(dgt);
  const pa = dg.pending_actions||{};
  for(const [nid,acts] of Object.entries(pa.per_node||{})){
    for(const a of acts){const r=dgt.insertRow();
      cell(r,(a.action||'action')+' (node '+nid+')');
      cell(r,a.reason||JSON.stringify(a));}}
  for(const b of (pa.broadcasts||[])){const r=dgt.insertRow();
    const a=b.action||{};
    cell(r,(a.action||'broadcast'));
    cell(r,(a.reason||'')+' delivered_to=['
      +(b.delivered_to||[]).join(',')+']');}
  if(dgt.rows.length===1){const r=dgt.insertRow();
    cell(r,'-'); cell(r,'no pending actions');}
  const inc = await get('incidents');
  const it = document.getElementById('incidents'); clear(it);
  for(const i of (inc.incidents||[])){const r=it.insertRow();
    cell(r,i.incident_id); cell(r,i.kind,'bad');
    cell(r,i.phase); cell(r,i.culprit_node);
    cell(r,i.stuck_op);
    cell(r,i.chaos&&i.chaos.point?i.chaos.point+' ('+i.chaos.kind+')':null);
    cell(r,(i.dumps||[]).length); cell(r,i.detail);}
  if(it.rows.length===1){const r=it.insertRow();
    cell(r,'-'); cell(r,'no incidents','ok');}
  const cm = await get('comm');
  const ft = document.getElementById('fabric'); clear(ft);
  const probing = Object.keys(cm.nodes||{}).length;
  for(const [axis,v] of Object.entries(cm.axes||{})){const r=ft.insertRow();
    cell(r,axis); cell(r,v.lat_us); cell(r,v.gbps); cell(r,probing);}
  if(ft.rows.length===1){const r=ft.insertRow();
    cell(r,'-'); cell(r,'no fabric probes yet');}
  const cj = await get('compile');
  const ct = document.getElementById('compiletab'); clear(ct);
  for(const [nid,v] of Object.entries(cj.nodes||{})){const r=ct.insertRow();
    cell(r,nid); cell(r,v.compile_s!==undefined?v.compile_s.toFixed(2):null);
    cell(r,v.hits); cell(r,v.misses,
      v.warm_expected&&v.misses>0?'bad':'');
    const hr=v.hit_ratio;
    cell(r,hr!==null&&hr!==undefined?(hr*100).toFixed(0)+'%':null,
      v.warm_expected&&hr!==null&&hr!==undefined&&hr<0.5?'bad':'');
    cell(r,v.stalls);
    cell(r,v.warm_expected?'yes':'no');
    cell(r,v.cache_enabled?'yes':'no',
      v.cache_enabled?'':'bad');}
  if(ct.rows.length===1){const r=ct.insertRow();
    cell(r,'-'); cell(r,'no compile events yet');}
  const mm = await get('mem');
  const mt = document.getElementById('memtab'); clear(mt);
  const gib = b=>b>0?(b/2**30).toFixed(2):null;
  for(const [nid,v] of Object.entries(mm.nodes||{})){const r=mt.insertRow();
    cell(r,nid); cell(r,gib(v.used_b)); cell(r,gib(v.limit_b));
    const hr=v.headroom_frac;
    cell(r,hr!==null&&hr!==undefined?(hr*100).toFixed(0)+'%':null,
      hr!==null&&hr!==undefined&&hr<0.08?'bad':'');
    cell(r,gib(v.rss_b)); cell(r,gib(v.shm_b));
    const subs=Object.entries(v.subsystems||{})
      .sort((a,b)=>b[1]-a[1]).slice(0,3)
      .map(([k,b])=>k+' '+(b/2**30).toFixed(2)+'G');
    cell(r,subs.join(', ')||null);}
  if(mt.rows.length===1){const r=mt.insertRow();
    cell(r,'-'); cell(r,'no memory samples yet');}
  const ck = await get('ckpt');
  const ckt = document.getElementById('ckpt'); clear(ckt);
  for(const [dir,v] of Object.entries(ck.dirs||{})){
    const commits = (v.commits||[]).length ? v.commits
      : [{step:null,reported:null,expected:null,sealed:null}];
    for(const c of commits){const r=ckt.insertRow();
      cell(r,dir); cell(r,v.committed_step); cell(r,c.step);
      cell(r,c.reported!==null?c.reported+'/'+c.expected:null);
      cell(r,c.sealed===null?null:(c.sealed?'yes':'no'),
        c.sealed===false&&c.error?'bad':(c.sealed?'ok':''));
      cell(r,c.bytes_written!==undefined?
        (c.bytes_written/1e6).toFixed(1):null);
      cell(r,c.error||null, c.error?'bad':'');}}
  if(ckt.rows.length===1){const r=ckt.insertRow();
    cell(r,'-'); cell(r,'no distributed commits');}
  }
  const ev = await get('events');
  const eb = document.getElementById('events');
  eb.replaceChildren(...(ev.events||[]).slice(-60).reverse().map(e=>{
    const d = document.createElement('div');
    // textContent: event payloads carry worker-controlled strings
    // (exit reasons, hang detail) — never render them as markup
    d.textContent = new Date(e.ts*1000).toISOString().substr(11,8)+' '
      +e.name+' '+JSON.stringify(e.content);
    return d;}));
}
function drawSpark(id, vals, fixedMax){
  const svg = document.getElementById(id);
  svg.innerHTML='';
  if(!vals.length) return;
  const w=480,h=60,max=fixedMax||Math.max(...vals,1e-9);
  const pts = vals.map((v,i)=>
    (i*(w-4)/Math.max(1,vals.length-1)+2)+','+(h-2-(v/max)*(h-8)));
  const pl = document.createElementNS('http://www.w3.org/2000/svg',
    'polyline');
  pl.setAttribute('points',pts.join(' '));
  pl.setAttribute('fill','none');
  pl.setAttribute('stroke','#3367d6');
  pl.setAttribute('stroke-width','1.5');
  svg.appendChild(pl);
}
refresh(); setInterval(refresh, 3000);
</script></body></html>"""


class DashboardServer:
    def __init__(self, master, port: int = 0):
        self._master = master
        dashboard = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802
                parsed = urlparse(self.path)
                route = parsed.path.rstrip("/").rsplit("/", 1)[-1]
                query = parse_qs(parsed.query)
                handler = {
                    "status": dashboard.status,
                    "nodes": dashboard.nodes,
                    "rendezvous": dashboard.rendezvous,
                    "datasets": dashboard.datasets,
                    "stats": dashboard.stats,
                    "events": dashboard.events,
                    "diagnosis": dashboard.diagnosis,
                    "incidents": dashboard.incidents,
                    "ckpt": dashboard.ckpt,
                    "recovery": dashboard.recovery,
                    "comm": dashboard.comm,
                    "mem": dashboard.mem,
                    "data": dashboard.data,
                    "compile": dashboard.compile_view,
                    "brain": dashboard.brain,
                }.get(route)
                if route == "metrics":
                    body = dashboard.metrics_page().encode()
                    ctype = "text/plain; version=0.0.4"
                elif route == "timeseries":
                    try:
                        res = float(query.get("res", ["10"])[0])
                    except ValueError:
                        res = 10.0
                    body = json.dumps(
                        dashboard.timeseries(
                            prefix=query.get("name", [""])[0], res=res
                        )
                    ).encode()
                    ctype = "application/json"
                elif route == "node":
                    try:
                        node_id = int(query.get("id", ["-1"])[0])
                    except ValueError:
                        node_id = -1
                    body = json.dumps(
                        dashboard.node_history(node_id)
                    ).encode()
                    ctype = "application/json"
                elif handler is not None:
                    body = json.dumps(handler()).encode()
                    ctype = "application/json"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- data sources (every master attribute optional: the dashboard
    # attaches to local and distributed masters alike) ---------------------

    def _metric_context(self):
        servicer = getattr(self._master, "servicer", None)
        return getattr(servicer, "metric_context", None)

    def status(self) -> dict:
        master = self._master
        context = master._job_context  # noqa: SLF001 - same subsystem
        status = {
            "job": context.job_name,
            "stage": context.get_job_stage(),
            "step": master.perf_monitor.completed_global_step,
            "speed": master.perf_monitor.running_speed(),
            "goodput": master.perf_monitor.goodput(),
            "training_goodput": master.perf_monitor.training_goodput(),
            "nodes": self.nodes(),
        }
        # hang verdict only — the full diagnosis payload (pending-action
        # copy under the JobContext lock) stays on /diagnosis, which the
        # page polls at a 5x slower cadence than this status endpoint
        diag = getattr(master, "diagnosis_manager", None) or getattr(
            master, "_diagnosis_manager", None
        )
        if diag is not None and hasattr(diag, "hang_verdict"):
            verdict = diag.hang_verdict()
            if verdict.get("hung_nodes"):
                status["hang"] = verdict
        metric_ctx = self._metric_context()
        if metric_ctx is not None:
            status["metrics"] = metric_ctx.job_summary()
            laggards = metric_ctx.step_laggards(tolerance=1)
            if laggards:
                status["step_laggards"] = laggards
            # device-evidence series (VERDICT r4 #4): the duty-cycle
            # straggler screen and worst-chip HBM pressure, same
            # sources the diagnostician/optimizer act on
            duty_laggards = metric_ctx.duty_cycle_laggards()
            if duty_laggards:
                status["duty_laggards"] = duty_laggards
            pressure = metric_ctx.max_hbm_pressure()
            if pressure:
                status["hbm_pressure"] = {
                    str(n): round(p, 3) for n, p in pressure.items()
                }
        return status

    def nodes(self) -> list:
        context = self._master._job_context  # noqa: SLF001
        now = time.time()
        metric_ctx = self._metric_context()
        latest = metric_ctx.latest_by_node() if metric_ctx else {}
        nodes = []
        for node in context.job_nodes_by_type(NodeType.WORKER).values():
            entry = {
                "id": node.id,
                "status": node.status,
                "relaunch_count": node.relaunch_count,
                "exit_reason": node.exit_reason,
                "heartbeat_age": (
                    round(now - node.heartbeat_time, 1)
                    if node.heartbeat_time else None
                ),
            }
            if latest.get(node.id):
                entry["metrics"] = latest[node.id]
            nodes.append(entry)
        return sorted(nodes, key=lambda n: n["id"])

    def node_history(self, node_id: int) -> dict:
        metric_ctx = self._metric_context()
        if metric_ctx is None:
            return {"resource": [], "steps": [], "hang": []}
        return metric_ctx.node_history(node_id)

    def rendezvous(self) -> dict:
        managers = getattr(self._master, "rdzv_managers", {}) or {}
        out = {}
        for name, manager in managers.items():
            params = manager.get_rdzv_params()
            out[name] = {
                "round": manager.rdzv_round,
                "waiting": manager.num_nodes_waiting(),
                "min_nodes": params.min_nodes,
                "max_nodes": params.max_nodes,
                "node_unit": params.node_unit,
                "not_joined": manager.not_joined_rdzv_nodes(),
            }
        return out

    def datasets(self) -> dict:
        task_manager = getattr(self._master, "task_manager", None)
        if task_manager is None:
            return {}
        out = {}
        for name, dataset in getattr(task_manager, "_datasets", {}).items():
            out[name] = {
                "epoch": dataset.get_epoch(),
                "completed": dataset.completed_count,
                "doing": len(dataset.doing),
                "todo": len(dataset.todo),
                "finished": dataset.completed(),
            }
        return out

    def stats(self) -> dict:
        reporter = getattr(self._master, "stats_reporter", None)
        if reporter is None:
            collector = getattr(self._master, "metric_collector", None)
            reporter = getattr(collector, "_reporter", None)
        records = reporter.records() if reporter is not None else []
        return {"records": records[-240:]}

    def events(self) -> dict:
        ring = getattr(self._master, "event_ring", None)
        return {"events": ring.recent(200) if ring is not None else []}

    def metrics_page(self) -> str:
        """Prometheus exposition of the process-wide RED registry, with
        the master's live job gauges (goodput, global step, alive
        nodes) folded in at render time."""
        from dlrover_tpu_torch.observability import metrics as obs_metrics

        reg = obs_metrics.registry()
        master = self._master
        perf = getattr(master, "perf_monitor", None)
        if perf is not None:
            try:
                reg.gauge_set(
                    "dlrover_tpu_goodput", perf.goodput(),
                    help="fraction of wall time spent training",
                )
                reg.gauge_set(
                    "dlrover_tpu_global_step",
                    perf.completed_global_step,
                    help="last reported global step",
                )
                reg.gauge_set(
                    "dlrover_tpu_speed_steps_per_s", perf.running_speed(),
                    help="recent training speed (steps/s)",
                )
            except Exception:  # noqa: BLE001 - gauges are best-effort
                pass
        context = getattr(master, "_job_context", None)
        if context is not None:
            try:
                reg.gauge_set(
                    "dlrover_tpu_alive_workers",
                    len(context.alive_node_ids(NodeType.WORKER)),
                    help="workers currently alive",
                )
            except Exception:  # noqa: BLE001
                pass
        return reg.render()

    def diagnosis(self) -> dict:
        master = self._master
        out: dict = {}
        diag = getattr(master, "diagnosis_manager", None) or getattr(
            master, "_diagnosis_manager", None
        )
        if diag is not None and hasattr(diag, "hang_verdict"):
            out["hang"] = diag.hang_verdict()
        context = getattr(master, "_job_context", None)
        pending = getattr(context, "pending_action_summary", None)
        if callable(pending):
            out["pending_actions"] = pending()
        return out

    def incidents(self) -> dict:
        """Flight-recorder incidents, newest first: kind, classified
        phase/culprit/stuck-op, chaos attribution, dump inventory, and
        the on-disk artifact dir (INCIDENT.json + merged Perfetto
        incident timeline)."""
        manager = getattr(self._master, "incident_manager", None)
        if manager is None:
            return {"incidents": [], "root": ""}
        return {
            "incidents": manager.list_incidents(),
            "root": manager.root,
        }

    def brain(self) -> dict:
        """Brain v2 view: the fleet arbiter's live snapshot when one
        runs in (or is attached to) this master — registered jobs,
        capacity/free pool, the recent decision log, and in-flight
        tracked actions.  A job master CONNECTED to a remote brain
        shows its reporter state instead; a master with neither shows
        ``enabled: false``."""
        for attr in ("brain", "fleet_arbiter"):
            arbiter = getattr(self._master, attr, None)
            if arbiter is not None and hasattr(arbiter, "snapshot"):
                return {"enabled": True, "role": "arbiter",
                        **arbiter.snapshot()}
        reporter = getattr(self._master, "brain_reporter", None)
        if reporter is not None:
            return {
                "enabled": True,
                "role": "reporter",
                "job": getattr(reporter, "_job", ""),
                "registered": getattr(reporter, "_registered", False),
            }
        return {"enabled": False}

    def comm(self) -> dict:
        """Comm observatory view: latest probe-measured fabric numbers
        per mesh axis (worst-case job rollups), per-node latest
        samples, and any slow_link incidents — "which link is slow"
        answerable with one curl."""
        servicer = getattr(self._master, "servicer", None)
        store = getattr(servicer, "timeseries", None)
        if store is None:
            return {"axes": {}, "nodes": {}}
        axes: dict = {}
        for name in store.names():
            if not name.startswith("job.comm."):
                continue
            parts = name.split(".")
            if len(parts) < 4:
                continue
            value = store.latest(name)
            if value is not None:
                axes.setdefault(parts[2], {})[parts[3]] = round(value, 6)
        out = {
            "axes": axes,
            "nodes": {
                str(node_id): entry
                for node_id, entry in store.comm_nodes().items()
            },
        }
        manager = getattr(self._master, "incident_manager", None)
        if manager is not None:
            out["slow_link_incidents"] = [
                incident for incident in manager.list_incidents()
                if incident.get("kind") == "slow_link"
            ]
        return out

    def mem(self) -> dict:
        """Memory observatory view: latest per-node byte accounts
        (used/limit/headroom, per-subsystem attribution, host RSS +
        shm staging), the worst-case job rollups, and any open memory
        incidents — "who owns the bytes / how close to OOM" answerable
        with one curl."""
        servicer = getattr(self._master, "servicer", None)
        store = getattr(servicer, "timeseries", None)
        if store is None:
            return {"nodes": {}, "job": {}}
        job: dict = {}
        for name in ("job.mem.used_b", "job.mem.headroom"):
            value = store.latest(name)
            if value is not None:
                job[name.rsplit(".", 1)[-1]] = round(value, 6)
        subs: dict = {}
        for name in store.names():
            if name.startswith("job.mem.sub."):
                value = store.latest(name)
                if value is not None:
                    subs[name[len("job.mem.sub."):]] = round(value, 1)
        if subs:
            job["subsystems"] = subs
        out = {
            "nodes": {
                str(node_id): entry
                for node_id, entry in store.mem_nodes().items()
            },
            "job": job,
        }
        manager = getattr(self._master, "incident_manager", None)
        if manager is not None:
            out["mem_incidents"] = [
                incident for incident in manager.list_incidents()
                if incident.get("kind") in (
                    "hbm_leak", "mem_pressure", "hbm_oom"
                )
            ]
        return out

    def compile_view(self) -> dict:
        """Compile observatory view: per-node cumulative compile
        seconds / cache hits+misses / stalls with the warm-expected
        and cache-enabled flags, the job rollups, and any open compile
        incidents — "which function recompiled and why" answerable
        with one curl (the per-function events ride the incident
        dumps)."""
        servicer = getattr(self._master, "servicer", None)
        store = getattr(servicer, "timeseries", None)
        if store is None:
            return {"nodes": {}, "job": {}}
        job: dict = {}
        for name in ("job.compile.s", "job.compile.hit_ratio"):
            value = store.latest(name)
            if value is not None:
                job[name[len("job.compile."):]] = round(value, 6)
        out = {
            "nodes": {
                str(node_id): entry
                for node_id, entry in store.compile_nodes().items()
            },
            "job": job,
        }
        manager = getattr(self._master, "incident_manager", None)
        if manager is not None:
            out["compile_incidents"] = [
                incident for incident in manager.list_incidents()
                if incident.get("kind") in (
                    "recompile_storm", "cache_cold"
                )
            ]
        return out

    def data(self) -> dict:
        """Datascope view: per-dataset and aggregate shard telemetry
        (backlog depth, lease p50/p99 service latency, queue wait,
        throughput) plus the recent ``job.data.*`` series — "is the
        input pipeline keeping up, and where does a lease spend its
        time" as one JSON page."""
        servicer = getattr(self._master, "servicer", None)
        telemetry = getattr(servicer, "shard_telemetry", None)
        store = getattr(servicer, "timeseries", None)
        out: dict = {"summary": {}, "series": {}}
        if telemetry is not None:
            out["summary"] = telemetry.summary()
        if store is not None:
            out["series"] = store.snapshot(
                res=10.0, prefix="job.data."
            ).get("series", {})
        return out

    def timeseries(self, prefix: str = "", res: float = 10.0) -> dict:
        """The master time-series store (goodput ledger shares, step
        times) downsampled at the ring closest to ``res`` seconds,
        optionally filtered to series names starting with ``prefix``."""
        servicer = getattr(self._master, "servicer", None)
        store = getattr(servicer, "timeseries", None)
        if store is None:
            return {"series": {}, "resolutions_s": []}
        return store.snapshot(res=res, prefix=prefix)

    def ckpt(self) -> dict:
        """Distributed checkpoint commit state: per-dir committed step
        and the coordinator's recent two-phase commit attempts."""
        servicer = getattr(self._master, "servicer", None)
        coordinator = getattr(servicer, "ckpt_coordinator", None)
        if coordinator is None:
            return {"dirs": {}}
        return coordinator.snapshot()

    def recovery(self) -> dict:
        """Peer-restore view: replica-group health (which processes can
        serve which shm snapshot step, announcement age) + the last
        recoveries' timings (ladder rung, MTTR, peer bandwidth) and any
        open mttr_budget incidents — "can the fleet restore itself, and
        how fast did it last do so" as one JSON page."""
        servicer = getattr(self._master, "servicer", None)
        broker = getattr(servicer, "peer_broker", None)
        out = broker.snapshot() if broker is not None else {
            "scopes": {}, "recoveries": [],
        }
        store = getattr(servicer, "timeseries", None)
        if store is not None:
            job = {}
            for name in ("job.recovery.mttr_s",
                         "job.recovery.peer_read_gbps"):
                value = store.latest(name)
                if value is not None:
                    job[name[len("job.recovery."):]] = round(value, 6)
            out["job"] = job
        manager = getattr(self._master, "incident_manager", None)
        if manager is not None:
            out["mttr_incidents"] = [
                incident for incident in manager.list_incidents()
                if incident.get("kind") == "mttr_budget"
            ]
        return out

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="dashboard"
        )
        self._thread.start()

    def stop(self):
        # shutdown() waits for a serve loop: one never started has none
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join()
            self._thread = None
        self._httpd.server_close()

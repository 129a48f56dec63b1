// PipelineMonitor.tsx: live per-service status (WS push + 30 s repoll),
// click-a-row log viewer, per-service re-trigger, queue stats, event feed.
import {api, h, main, esc, short, when, table, toast, ws, USER}
  from "/static/app.js";

const SERVICES = ["yolo", "sam3", "dinov3", "tleap", "tcn", "transformer",
                  "gnn", "ml", "tracking", "fusion", "analysis"];

export default async function PipelineMonitor() {
  const queue = await api("/api/pipeline/queue");
  const privileged = USER && ["admin", "researcher"].includes(USER.role);
  main.append(h(`<div class="panel"><h2>Live events
      <span class="badge" id="wsstate">connecting…</span>
      <span class="dim">(websocket /api/ws/pipeline)</span></h2>
    <pre id="feed" style="max-height:160px">waiting for events…</pre></div>
  <div class="panel"><h2>Pipeline services
      <span class="dim" id="refreshed"></span></h2><div id="svc"></div></div>
  <div class="vs">
    <div class="panel" style="flex:1"><h2>Queue</h2><div class="kv">
      ${Object.entries(queue.jobs_by_status || {}).map(([k, v]) =>
        `<span class="dim">${esc(k)}</span><b>${v}</b>`).join("")}
      <span class="dim">bus messages</span><b>${queue.bus_messages}</b>
      <span class="dim">bus errors</span>
      <b class="${queue.bus_errors ? 'bad' : ''}">${queue.bus_errors}</b>
    </div></div>
    ${privileged ? `<div class="panel" style="flex:1"><h2>Re-trigger</h2>
      <div class="row"><input id="rv" placeholder="video id">
        <select id="rs"><option>all</option>${SERVICES.map(s =>
          `<option>${s}</option>`).join("")}</select>
        <button class="ghost" id="rgo">Re-run</button></div>
      <div class="dim">or click ↻ on a service row below</div></div>` : ""}
  </div>
  <div class="panel"><h2>Service logs <span class="dim">(bus journal —
      click a service row above, or pick here)</span></h2>
    <div class="row"><select id="logsvc">${SERVICES.map(s =>
        `<option>${s}</option>`).join("")}</select>
      <button class="ghost" id="loggo">Load</button>
      <label><input type="checkbox" id="logauto"> auto-refresh</label></div>
    <pre id="logs">pick a service</pre></div>`));

  // -- live feed ----------------------------------------------------------
  const lines = [];
  const feed = document.getElementById("feed");
  const wsstate = document.getElementById("wsstate");
  const sock = ws("pipeline", (msg) => {
    lines.unshift(`${new Date().toLocaleTimeString()}  ${msg.type || ""}  ` +
                  `${msg.video_id || ""}`);
    feed.textContent = lines.slice(0, 14).join("\n");
    if ((msg.type || "").startsWith("pipeline")) refresh();  // status push
  });
  if (sock) {
    sock.onopen = () => { wsstate.textContent = "live";
                          wsstate.className = "badge ok"; };
    sock.onclose = () => { wsstate.textContent = "disconnected";
                           wsstate.className = "badge bad"; };
  }

  // -- status table (click row -> logs; ↻ -> re-trigger prompt) ----------
  async function refresh() {
    if (!document.getElementById("svc")) return;       // page navigated away
    const status = await api("/api/pipeline/status");
    document.getElementById("refreshed").textContent =
      "updated " + new Date().toLocaleTimeString();
    document.getElementById("svc").innerHTML = status.length
      ? table(status, [
          ["service", s => esc(s.service_name)],
          ["status", s => `<span class="${
            s.status === 'healthy' ? 'ok' : 'warn'}">${esc(s.status)}</span>`],
          ["jobs", s => s.active_jobs],
          ["ok", s => s.success_count],
          ["err", s => `<span class="${s.error_count ? 'bad' : ''}">${
            s.error_count}</span>`],
          ["last beat", s => `<span class="dim">${when(s.last_heartbeat)
            }</span>`],
          ["last error", s => `<span class="dim">${
            esc((s.last_error || "").slice(0, 60))}</span>`],
          ["", s => privileged ? `<button class="mini rt"
            data-s="${esc(s.service_name)}">↻</button>` : ""],
        ], {rowAttr: s => `class="click" data-svc="${esc(s.service_name)}"`})
      : `<span class="dim">no heartbeats yet — services post
          /api/pipeline/heartbeat as they work</span>`;
    document.querySelectorAll("tr[data-svc]").forEach(tr => {
      tr.onclick = () => {
        const sel = document.getElementById("logsvc");
        if ([...sel.options].some(o => o.value === tr.dataset.svc))
          sel.value = tr.dataset.svc;
        loadLogs();
      };
    });
    document.querySelectorAll("button.rt").forEach(b => {
      b.onclick = async (e) => {
        e.stopPropagation();
        const vid = document.getElementById("rv").value.trim();
        if (!vid) return toast("enter a video id first", "warn");
        try {
          await api(`/api/pipeline/retrigger/${b.dataset.s}/${vid}`,
                    {method: "POST"});
          toast(`${b.dataset.s} re-triggered`);
        } catch (err) { toast(err.message, "bad"); }
      };
    });
  }
  await refresh();
  const poll = setInterval(() => {
    if (!document.getElementById("svc")) return clearInterval(poll);
    refresh().catch(() => {});
  }, 30000);                                 // reference: 30 s repoll

  const rgo = document.getElementById("rgo");
  if (rgo) rgo.onclick = async () => {
    const vid = document.getElementById("rv").value.trim();
    if (!vid) return toast("enter a video id", "warn");
    try {
      const svc = document.getElementById("rs").value;
      await api(`/api/pipeline/retrigger/${svc}/${vid}`, {method: "POST"});
      toast("re-triggered");
    } catch (e) { toast(e.message, "bad"); }
  };

  // -- logs ---------------------------------------------------------------
  async function loadLogs() {
    const svc = document.getElementById("logsvc").value;
    const logs = await api(`/api/pipeline/logs/${svc}`);
    document.getElementById("logs").textContent =
      logs.messages.map(m =>
        `${new Date(m.ts * 1000).toLocaleTimeString()}  ${m.subject}  ` +
        `${JSON.stringify(m.payload).slice(0, 110)}`).join("\n") +
      (logs.errors.length ? "\n\nERRORS:\n" +
        logs.errors.map(e => JSON.stringify(e)).join("\n") : "") ||
      "no messages for this service yet";
  }
  document.getElementById("loggo").onclick = loadLogs;
  const logPoll = setInterval(() => {
    const cb = document.getElementById("logauto");
    if (!cb) return clearInterval(logPoll);
    if (cb.checked) loadLogs().catch(() => {});
  }, 5000);
}

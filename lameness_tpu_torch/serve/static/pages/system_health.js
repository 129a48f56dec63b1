// SystemHealth.tsx (476 LoC): infrastructure monitoring — overall status
// banner with per-component dots + issue list, per-dependency cards
// (bus/NATS, database, vector store, disk, throughput), service table,
// live WS health updates + 30 s repoll + manual refresh.
import {api, h, main, fmt, esc, when, table, ws} from "/static/app.js";

const ICON = {healthy: "✓", degraded: "◐", warning: "◐", unhealthy: "✗",
              critical: "✗", unconfigured: "○"};
const COLOR = {healthy: "var(--ok)", degraded: "var(--warn)",
               warning: "var(--warn)", unhealthy: "var(--bad)",
               critical: "var(--bad)", unconfigured: "var(--dim)"};
const stc = (s) => `<span style="color:${COLOR[s] || "var(--dim)"}">${
  ICON[s] || "?"} ${esc(s)}</span>`;

export default async function SystemHealth() {
  main.append(h(`<div class="panel"><h2>System health
      <span class="dim">infrastructure monitoring and system status</span>
      <span id="sh-live" class="dim">○ connecting…</span>
      <button class="mini" id="sh-refresh">refresh</button></h2>
    <div id="sh-overview"></div>
    <div class="grid" id="sh-cards" style="margin-top:8px"></div>
    <div class="panel" style="margin-top:8px"><h2>Services</h2>
      <div id="sh-svc"></div></div>
    <details class="dim" style="margin-top:6px"><summary>raw</summary>
      <pre id="sh-raw" style="max-height:260px"></pre></details></div>`));

  const load = async () => {
    const [hl, nats, pg, qd, disk, tp] = await Promise.all([
      api("/api/health/overview"),
      api("/api/health/nats").catch(() => null),
      api("/api/health/postgres").catch(() => null),
      api("/api/health/qdrant").catch(() => null),
      api("/api/health/disk").catch(() => null),
      api("/api/health/throughput").catch(() => null)]);

    document.getElementById("sh-overview").innerHTML =
      `<div class="panel" style="border:1px solid ${COLOR[hl.status]
        || "var(--line)"}">
      <div class="row" style="justify-content:space-between;flex-wrap:wrap">
        <div><span style="font-size:20px;font-weight:700;color:${
          COLOR[hl.status]}">${ICON[hl.status]} ${esc(hl.status)}</span>
          <span class="dim" style="margin-left:8px">updated ${
            when(hl.timestamp)}</span>
          <span class="dim">· up ${fmt(hl.uptime_s / 60, 0)} min</span></div>
        <div class="row">${Object.entries(hl.components || {}).map(
          ([n, s]) => `<span><i style="display:inline-block;width:8px;
            height:8px;border-radius:50%;background:${COLOR[s]
            || "var(--dim)"}"></i> ${esc(n)}</span>`).join("")}</div></div>
      ${(hl.issues || []).length ? `<div style="margin-top:6px;
          border-top:1px solid var(--line);padding-top:6px">
        <b style="font-size:13px">Issues</b>
        ${hl.issues.map(i => `<div class="dim" style="font-size:12px">
          ⚠ ${esc(i)}</div>`).join("")}</div>` : ""}</div>`;

    const cards = [];
    if (nats) cards.push(`<div class="panel"><h3>⚡ Message bus
        ${stc(nats.status)}</h3><div class="kv">
      <span class="dim">backend</span><b>${esc(nats.backend)}</b>
      <span class="dim">messages</span><b>${nats.messages}</b>
      <span class="dim">handler errors</span>
        <b class="${nats.errors ? "bad" : ""}">${nats.errors}</b></div></div>`);
    if (pg) cards.push(`<div class="panel"><h3>🗄 Database
        ${stc(pg.status)}</h3><div class="kv">
      <span class="dim">backend</span><b>${esc(pg.backend || "")}</b>
      <span class="dim">users</span><b>${pg.users ?? "—"}</b>
      <span class="dim">size</span><b>${fmt(pg.database_size_mb, 2)} MB</b>
      <span class="dim">response</span><b>${fmt(pg.response_time_ms, 2)} ms
      </b></div></div>`);
    if (qd) cards.push(`<div class="panel"><h3>🧭 Vector store
        ${stc(qd.status)}</h3><div class="kv">
      <span class="dim">backend</span><b>${esc(qd.backend || "")}</b>
      ${Object.entries(qd.collections || {}).map(([n, c]) =>
        `<span class="dim">${esc(n)}</span><b>${c} vectors</b>`).join("")
        || '<span class="dim">collections</span><b>none</b>'}
      <span class="dim">response</span><b>${fmt(qd.response_time_ms, 2)} ms
      </b></div></div>`);
    // /api/health/disk is a LIST of per-path DiskUsage entries
    // (reference health.py) — render the fullest volume
    const dk = Array.isArray(disk) && disk.length
      ? disk.reduce((a, b) => b.percent_used > a.percent_used ? b : a)
      : null;
    if (dk) cards.push(`<div class="panel"><h3>💾 Disk
        ${stc(dk.status)}</h3>
      <div class="bar" style="margin:6px 0"><i style="width:${
        dk.percent_used}%;background:${COLOR[dk.status]}"></i></div>
      <div class="kv"><span class="dim">path</span>
        <b class="dim">${esc(dk.path)}</b>
      <span class="dim">used</span><b>${dk.percent_used}%</b>
      <span class="dim">free</span><b>${dk.free_gb} GB</b>
      <span class="dim">thresholds</span><b class="dim">warn 80% /
        critical 90%</b></div></div>`);
    if (tp) cards.push(`<div class="panel"><h3>📈 Throughput</h3>
      <div class="kv">
      <span class="dim">messages (window)</span><b>${tp.messages}</b>
      <span class="dim">videos analyzed</span><b>${tp.videos_analyzed}</b>
      <span class="dim">videos/hour</span><b>${fmt(tp.videos_per_hour, 1)}
      </b></div></div>`);
    document.getElementById("sh-cards").innerHTML = cards.join("");

    const svc = Object.entries(hl.services || {});
    document.getElementById("sh-svc").innerHTML = svc.length
      ? table(svc, [["service", e => esc(e[0])],
                    ["status", e => stc(e[1])]])
      : `<span class="dim">no heartbeats yet</span>`;
    document.getElementById("sh-raw").textContent =
      JSON.stringify({overview: hl, nats, postgres: pg, qdrant: qd, disk,
                      throughput: tp}, null, 2);
  };
  await load();

  document.getElementById("sh-refresh").onclick = load;
  const live = document.getElementById("sh-live");
  const sock = ws("health", () => { live.textContent = "● live"; load(); });
  if (sock) {
    sock.onopen = () => live.textContent = "● live";
    sock.onclose = () => live.textContent = "○ disconnected";
  } else live.textContent = "○ no WS";
  const timer = setInterval(() => {
    if (!document.getElementById("sh-refresh")) return clearInterval(timer);
    load();
  }, 30000);
}
